"""Public entry points of the port's kernels, dispatched by device.

A CPU tensor takes the plain PyTorch version (``repro_torch.kernels.ref``),
which autograd differentiates as it runs.  A CUDA tensor launches the
hand-written kernel, or raises if its build or its launch fails: there is
no fallback from the card to the plain version.

The kernels compute forward passes only, as the Pallas kernels they port
do.  On the card ``flash_attention``, ``mamba_scan``, ``conv1d_silu`` and
``dt_softplus`` are autograd functions: the forward launches the kernel,
and the backward is the gradient of the plain version, recomputed from the
saved inputs (``ref.flash_attention_bwd_ref``, ``ref.mamba_scan_bwd_ref``,
``ref.recomputed_grads``).  So an output that needs a gradient gets the
plain version's.

Each entry point takes the kernel's block shapes as the reference's
``ops`` does (``**kw``: the matmul's ``bm``, ``bn``, ``bk``, flash
attention's ``bq``, ``bk``, the scan's ``bd``, ``chunk``) and forwards them
to the kernel on the card; on the CPU they are checked as the kernel checks
them, so that a tile it does not instantiate raises on both devices, and
change nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mamba_coeffs as _coeffs
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import nvdla_matmul as _matmul
from repro_torch.kernels import ref


def _dispatch(name, plain, kernel, device, /, *args, **kw):
    if device.type == "cpu":
        return plain(*args, **kw)
    if device.type == "cuda":
        return kernel(*args, **kw)
    raise ValueError(f"{name}: no implementation for device {device}")


def _matmul_plain(a, b, **kw):
    """The plain version, after the check the kernel makes of the blocks
    given: a block it does not instantiate raises here as on the card."""
    if kw:
        _matmul.tiling_of(a.shape[0], b.shape[1], a.shape[1], a.dtype, **kw)
    return ref.matmul_ref(a, b)


def matmul(a, b, **kw):
    """a: (M, K) @ b: (K, N) -> (M, N) in a's dtype, float32 accumulation.
    ``kw`` (``bm``, ``bn``, ``bk``, ``splits``, ``kernel``) goes to the
    kernel (``nvdla_matmul.matmul``), as the reference's ``ops.matmul``
    forwards its blocks; on the CPU it is checked as the kernel checks it
    and changes nothing else."""
    return _dispatch("matmul", _matmul_plain, _matmul.matmul, a.device, a, b,
                     **kw)


def _no_grads(ctx, grads):
    """``grads`` followed by a None for each of forward's other inputs."""
    return (*grads, *(None,) * (len(ctx.needs_input_grad) - len(grads)))


class _FlashAttention(torch.autograd.Function):
    """The flash kernel forward at the tile given (``kw``: ``bq``, ``bk``,
    ``kernel``); the plain version's gradient backward, which has no
    tile."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kw=None):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      **(kw or {}))

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return _no_grads(ctx, ref.flash_attention_bwd_ref(
            q, k, v, dout, causal=ctx.causal, window=ctx.window))


class _MambaScan(torch.autograd.Function):
    """The scan kernel forward at the tile given (``kw``: ``bd``,
    ``chunk``); the plain version's gradient backward, which has no
    tile."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, D, h0, return_state, kw=None):
        ctx.save_for_backward(x, dt, B, C, A, D, h0)
        ctx.return_state = return_state
        return _mamba.mamba_scan(x, dt, B, C, A, D, h0=h0,
                                 return_state=return_state, **(kw or {}))

    @staticmethod
    def backward(ctx, dy, dh=None):
        x, dt, B, C, A, D, h0 = ctx.saved_tensors
        return _no_grads(ctx, ref.mamba_scan_bwd_ref(
            x, dt, B, C, A, D, h0, dy, dh if ctx.return_state else None))


class _Conv1dSilu(torch.autograd.Function):
    """The conv1d_silu kernel forward; the plain version's gradient
    backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return _coeffs.conv1d_silu(x, w, b)

    @staticmethod
    def backward(ctx, dy, dyf):
        return ref.recomputed_grads(ref.conv1d_silu_ref, ctx.saved_tensors,
                                    (dy, dyf))


class _DtSoftplus(torch.autograd.Function):
    """The dt_softplus kernel forward; the plain version's gradient
    backward."""

    @staticmethod
    def forward(ctx, p, bias):
        ctx.save_for_backward(p, bias)
        return _coeffs.dt_softplus(p, bias)

    @staticmethod
    def backward(ctx, dout):
        return ref.recomputed_grads(ref.dt_softplus_ref, ctx.saved_tensors,
                                    (dout,))


def _flash_apply(q, k, v, *, causal, window, **kw):
    return _FlashAttention.apply(q, k, v, causal, window, kw)


def _scan_apply(x, dt, B, C, A, D, *, h0, return_state, **kw):
    return _MambaScan.apply(x, dt, B, C, A, D, h0, return_state, kw)


def _flash_plain(q, k, v, *, causal, window, **kw):
    """The plain version, after the check the kernel makes of the tile
    given."""
    if kw:
        _flash.tile_of(q.shape[-1], q.dtype, **kw)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def _scan_plain(x, dt, B, C, A, D, *, h0, return_state, **kw):
    """The plain version, after the check the kernel makes of the tile
    given."""
    if kw:
        _mamba.tile_of(**kw)
    return ref.mamba_scan_ref(x, dt, B, C, A, D, h0=h0,
                              return_state=return_state)


def flash_attention(q, k, v, *, causal=True, window=0, **kw):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D).  KV stays at its native
    ``Hkv`` heads on both paths.  ``kw`` (``bq``, ``bk``, ``kernel``) goes
    to the kernel (``flash_attention.flash_attention``), as the reference's
    ``ops.flash_attention`` forwards it; ``flash_attention.tile_of`` says
    what raises."""
    return _dispatch("flash_attention", _flash_plain, _flash_apply,
                     q.device, q, k, v, causal=causal, window=window, **kw)


def mamba_scan(x, dt, B, C, A, D, h0=None, return_state=False, **kw):
    """x, dt: (b, S, d); B, C: (b, S, N); A: (d, N) and D: (d,) float32;
    h0: the starting state (b, d, N) float32, zeros if None.  Returns y:
    (b, S, d) in x's dtype, and with ``return_state`` the pair (y, h_S),
    h_S the final state (b, d, N) float32.  ``kw`` (``bd``, ``chunk``) goes
    to the kernel (``mamba_scan.mamba_scan``), as the reference's
    ``ops.mamba_scan`` forwards it; ``mamba_scan.tile_of`` says what
    raises."""
    return _dispatch("mamba_scan", _scan_plain, _scan_apply, x.device, x,
                     dt, B, C, A, D, h0=h0, return_state=return_state, **kw)


def conv1d_silu(x, w, b):
    """Mamba1's causal conv, bias and silu.  x: (b, S, d), rows at any
    stride (the in_proj product's first d columns, read in place on the
    card); w: (d, k); b: (d,).  Returns (y, yf): y (b, S, d) in x's type,
    yf its float32 widening.  The card's kernel takes bf16 and rounds once
    (``mamba_coeffs.conv1d_silu``); the plain version rounds each op
    (``ref.conv1d_silu_ref``)."""
    return _dispatch("conv1d_silu", ref.conv1d_silu_ref, _Conv1dSilu.apply,
                     x.device, x, w, b)


def dt_softplus(p, bias):
    """Mamba1's dt: softplus(float(p) + bias), float32.  p: (..., d) the
    dt_proj product; bias: (d,) float32."""
    return _dispatch("dt_softplus", ref.dt_softplus_ref, _DtSoftplus.apply,
                     p.device, p, bias)
