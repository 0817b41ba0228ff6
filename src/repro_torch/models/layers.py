"""Common layers: norms, RoPE, MLPs and their parameter init.

Parameters are plain dicts of tensors.  A dense weight is kept in the JAX
package's ``(in, out)`` layout and applied as ``x @ w``.  Init draws from an
explicit ``torch.Generator`` with the reference's distributions and scales;
the numbers differ from ``jax.random``'s, so tests carry the reference's
parameters across with ``repro_torch.convert``.  ``mlp_apply``'s down
projection closes a tensor-parallel region (``dist.tp.tp_project``): off a
mesh it is the plain product.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.spans import spanned
from repro_torch.dist import tp


def dense_init(gen, in_dim, out_dim, *, dtype=torch.bfloat16, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn(in_dim, out_dim, generator=gen, device=gen.device,
                    dtype=torch.float32) * scale
    return w.to(dtype)


def embed_init(gen, vocab, d_model, *, dtype=torch.bfloat16):
    w = torch.randn(vocab, d_model, generator=gen, device=gen.device,
                    dtype=torch.float32) * 0.02
    return w.to(dtype)


def norm_init(d_model, device):
    # norm scales stay fp32
    return torch.ones(d_model, dtype=torch.float32, device=device)


def rmsnorm(x, scale, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layernorm(x, scale, eps=1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale).to(x.dtype)


@spanned("repro_torch.norm")
def apply_norm(kind, x, scale):
    return rmsnorm(x, scale) if kind == "rmsnorm" else layernorm(x, scale)


def rope_tables(positions, dim, theta, scaling=None):
    """positions: (...,) integer -> cos/sin of shape positions.shape + (dim/2,).
    ``scaling``: None, or a ``YarnConfig``: DeepSeek-V2's YaRN frequencies
    (``yarn_inv_freq``), the tables times ``yarn_mscale(factor, mscale) /
    yarn_mscale(factor, mscale_all_dim)``."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    if scaling is not None:
        inv = yarn_inv_freq(inv, dim, theta, scaling)
    ang = positions.float()[..., None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    if scaling is not None:
        m = yarn_mscale(scaling.factor, scaling.mscale) \
            / yarn_mscale(scaling.factor, scaling.mscale_all_dim)
        cos, sin = cos * m, sin * m
    return cos, sin


def yarn_mscale(factor, mscale):
    """YaRN's attention factor ``0.1 mscale ln(factor) + 1`` (1 where
    ``factor`` <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_softmax_factor(scaling):
    """What DeepSeek-V2 multiplies its softmax scale by under ``scaling``
    (None or a ``YarnConfig``): ``yarn_mscale(factor, mscale_all_dim)**2``,
    or 1."""
    if scaling is None or not scaling.mscale_all_dim:
        return 1.0
    return yarn_mscale(scaling.factor, scaling.mscale_all_dim) ** 2


def yarn_inv_freq(inv, dim, theta, scaling):
    """DeepSeek-V2's YaRN frequencies from the plain ones ``inv`` (dim/2,):
    a frequency whose wavelength fits ``beta_fast`` times into the original
    context is kept, one that fits fewer than ``beta_slow`` times is
    divided by ``factor``, and those between are blended along a linear
    ramp over their indices."""
    orig = scaling.original_max_position_embeddings

    def corr(rotations):
        return dim * math.log(orig / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(corr(scaling.beta_fast)), 0)
    high = min(math.ceil(corr(scaling.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float32, device=inv.device)
    ramp = ((i - low) / (high - low)).clamp(0, 1)
    return inv / scaling.factor * ramp + inv * (1 - ramp)


@spanned("repro_torch.rope")
def apply_rope(x, cos, sin):
    """x: (..., S, D); cos/sin: broadcastable (..., S, D/2).  Rotates the two
    halves of D (not interleaved pairs)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(n_ctx, d_model, device="cpu"):
    """Whisper's encoder position table (n_ctx, d_model) in float32: sines
    then cosines, computed in numpy float64 and rounded once, as the
    reference computes it."""
    pos = np.arange(n_ctx)[:, None]
    dim = np.arange(0, d_model, 2)[None, :] / d_model
    ang = pos / (10_000.0 ** dim)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# MLP


def mlp_init(gen, d_model, d_ff, activation, *, dtype=torch.bfloat16):
    p = {"up": dense_init(gen, d_model, d_ff, dtype=dtype),
         "down": dense_init(gen, d_ff, d_model, dtype=dtype)}
    if activation in ("swiglu", "geglu"):
        p["gate"] = dense_init(gen, d_model, d_ff, dtype=dtype)
    return p


def _act(name, x):
    if name in ("swiglu", "silu"):
        return F.silu(x)
    return F.gelu(x, approximate="tanh")  # geglu and plain gelu


def mlp_apply(p, x, activation):
    """The MLP; where ``up`` is this rank's ``d_ff`` shard (the train step
    over a ``model`` axis), column-parallel ``gate``/``up`` and a
    row-parallel ``down`` (``dist.tp``)."""
    x = tp.enter(x, tp.shard_dim(p["up"]) == 1)
    up = x @ p["up"]
    if "gate" in p:
        up = _act(activation, x @ p["gate"]) * up
    else:
        up = _act(activation, up)
    return tp.tp_project(up, p["down"])
