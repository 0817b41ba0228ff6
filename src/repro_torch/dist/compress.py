"""Gradient compression: block-wise int8 quantization with stochastic
rounding and error feedback, for bandwidth-bound DP all-reduces; the
port's copy of the JAX package's ``repro.dist.compress``.

The quantizer is unbiased (stochastic rounding) and the residual of each
step is fed back into the next, so the running quantized sum tracks the true
sum (1-bit-Adam-style error feedback).  The noise comes from an explicit
``torch.Generator``, drawn in one place (``_uniform``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import tree
from repro_torch.dist import context as dist_ctx

BLOCK = 256


def _uniform(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Float32 noise uniform on [-0.5, 0.5): the stochastic rounding's."""
    return torch.rand(shape, generator=gen, device=device) - 0.5


def quantize_int8(x, gen: torch.Generator,
                  block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten, pad to ``block`` and quantize per-block to int8.

    Returns (q (n_blocks, block) int8, scale (n_blocks, 1) float32).  The LSB
    is ``max|block| / 127`` so the worst-case error is one LSB."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    xb = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = xb.abs().amax(1, keepdim=True) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    y = xb / scale
    # stochastic rounding: unbiased, error <= 1 LSB
    u = _uniform(y.shape, gen, y.device)
    q = torch.clamp(torch.round(y + u), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale, shape, size) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:size].reshape(shape)


def compressed_psum_grads(grads, mesh, axis: str, gen: torch.Generator,
                          err: Optional[dict] = None):
    """Quantize-reduce-dequantize a gradient tree over ``axis``.

    ``err`` is the previous step's residual tree (error feedback); pass the
    returned residual back in on the next call.  The dequantized leaves are
    averaged over the ranks of ``axis`` (an ``all_reduce`` over its group)
    only when that mesh axis has more than one rank; otherwise (absent or
    of size 1, single-shard tests) the quantize/dequantize round-trip, and
    therefore the residual dynamics, are the same.  The leaves draw their
    noise from ``gen`` one after the other, in tree order."""
    flat = tree.flatten(grads)
    errs = tree.flatten(err) if err is not None else {}
    out, res = {}, {}
    for key, g in flat.items():
        target = g if key not in errs else g + errs[key]
        q, scale = quantize_int8(target, gen)
        deq = dequantize_int8(q, scale, g.shape, g.numel())
        res[key] = target - deq
        dist_ctx.all_reduce(deq, axis, op="mean", mesh=mesh)
        out[key] = deq.to(g.dtype)
    return tree.unflatten(grads, out), tree.unflatten(grads, res)
