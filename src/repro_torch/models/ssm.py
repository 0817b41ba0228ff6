"""State-space models: Mamba1, the mixer of the ssm family (falcon_mamba_7b).

The port of the reference's ``models/ssm.py``, Mamba1 only (Mamba2's SSD
comes with the hybrid family).  Three forms of the sequence mix, as in the
reference:

  - ``scan``     : the selective scan of ``kernels.ops.mamba_scan``: the CUDA
                   kernel on the card, its plain loop on the CPU.  It takes x,
                   dt, B, C, A and D as they are and never builds the
                   (B, S, d_inner, N) decay and input tensors;
  - ``unrollU``  : U sequential steps per turn of a loop over S / U turns;
  - ``chunked``  : an associative scan inside chunks of ``ssm.chunk`` steps,
                   sequential across chunks.

``unrollU`` and ``chunked`` are plain torch forms of the same function, kept
for parity with the reference; the serving path runs ``scan``.  Types follow
the reference: projections and the causal conv in bf16, dt, B and C in
float32, x widened to float32 for the scan, the final state float32 and the
conv tail bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init


# ---------------------------------------------------------------------------
# init


def mamba1_init(gen, cfg: ModelConfig, dtype=torch.bfloat16):
    """One Mamba1 mixer's params from ``gen``, with the reference's
    distributions and types: projections bf16, ``dt_bias``, ``A_log`` and
    ``D`` float32."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    dt_rank = max(1, math.ceil(d / 16))
    N = s.d_state
    dev = gen.device
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev)[None] \
        .repeat(d_in, 1)
    return {
        "in_proj": dense_init(gen, d, 2 * d_in),
        "conv_w": torch.randn(d_in, s.d_conv, generator=gen, device=dev,
                              dtype=torch.float32).to(dtype) * 0.2,
        "conv_b": torch.zeros(d_in, dtype=dtype, device=dev),
        "x_proj": dense_init(gen, d_in, dt_rank + 2 * N),
        "dt_proj": dense_init(gen, dt_rank, d_in),
        "dt_bias": torch.full((d_in,), -4.6, dtype=torch.float32, device=dev),
        "A_log": torch.log(A),
        "D": torch.ones(d_in, dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, d_in, d),
    }


# ---------------------------------------------------------------------------
# causal depthwise conv (kernel k, as a sum of shifts — k is 4)


def causal_conv1d(x, w, b):
    """x: (B, S, C); w: (C, k); returns (B, S, C)."""
    k, S = w.shape[1], x.shape[1]
    out = x * w[None, None, :, -1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[None, None, :, -1 - i]
    return out + b[None, None]


def conv1d_step(x_t, conv_state, w, b):
    """x_t: (B, C); conv_state: (B, C, k-1) past inputs.  Returns (y, state)."""
    full = torch.cat([conv_state, x_t[..., None]], dim=-1)        # (B, C, k)
    y = torch.sum(full * w[None], dim=-1) + b[None]
    return y, full[..., 1:]


# ---------------------------------------------------------------------------
# mamba1 selective scan


def _ssm_coeffs1(p, xz, cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    N = s.d_state
    dt_rank = p["dt_proj"].shape[0]
    x, z = xz[..., :d_in], xz[..., d_in:]
    x = F.silu(causal_conv1d(x, p["conv_w"], p["conv_b"]))
    proj = x @ p["x_proj"]
    # the bf16 product plus the float32 bias is float32, as in the reference
    dt = F.softplus((proj[..., :dt_rank] @ p["dt_proj"]).float()
                    + p["dt_bias"])                             # (B, S, d_in)
    Bm = proj[..., dt_rank:dt_rank + N].float()                 # (B, S, N)
    Cm = proj[..., dt_rank + N:].float()                        # (B, S, N)
    A = -torch.exp(p["A_log"])                                  # (d_in, N)
    return x, z, dt, Bm, Cm, A


def _scan_unrolled(da, dbx, Cm, h, U):
    """U sequential steps per turn: the same arithmetic as one loop."""
    S = da.shape[1]
    if S % U:
        raise ValueError(f"unroll{U} needs S % {U} == 0, got S={S}")
    ys = []
    for t0 in range(0, S, U):
        for t in range(t0, t0 + U):
            h = da[:, t] * h + dbx[:, t]
            ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return torch.stack(ys, 1), h


def _assoc_scan(a, b):
    """Inclusive scan along dim 1 of the pairs (a, b) under
    ``(l, r) -> (l_a r_a, l_b r_a + r_b)``, by doubling (Hillis-Steele)."""
    k = 1
    while k < a.shape[1]:
        a, b = (torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], 1),
                torch.cat([b[:, :k], b[:, :-k] * a[:, k:] + b[:, k:]], 1))
        k *= 2
    return a, b


def _scan_chunked(da, dbx, Cm, h, c):
    """An associative scan inside chunks of c steps, sequential across
    them."""
    S = da.shape[1]
    if S % c:
        raise ValueError(f"chunked needs S % chunk == 0, got S={S}, "
                         f"chunk={c}")
    ys = []
    for t0 in range(0, S, c):
        pa, pb = _assoc_scan(da[:, t0:t0 + c], dbx[:, t0:t0 + c])
        hs = pa * h[:, None] + pb                             # (B, c, d, N)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Cm[:, t0:t0 + c]))
        h = hs[:, -1]
    return torch.cat(ys, 1), h


def mamba1_forward(p, x_seq, cfg: ModelConfig, impl="scan", state=None):
    """x_seq: (B, S, d_model) -> (out, final state dict(conv, ssm)).

    state (a carried state): dict(conv (B, d_in, k-1), ssm (B, d_in, N));
    as in the reference, only its ``ssm`` part is read.
    """
    s = cfg.ssm
    B, S, _ = x_seq.shape
    d_in = s.expand * cfg.d_model
    N = s.d_state
    xz = x_seq @ p["in_proj"]
    # conv tail = last (k-1) pre-conv inputs, for decode continuation; a
    # copy, since a view would hold the whole xz for as long as the state
    conv_tail = xz[:, -(s.d_conv - 1):, :d_in].transpose(1, 2).contiguous()
    x, z, dt, Bm, Cm, A = _ssm_coeffs1(p, xz, cfg)
    xf = x.float()
    h0 = None if state is None else state["ssm"]

    if impl == "scan":
        # the kernel adds D x itself
        y, hT = ops.mamba_scan(xf, dt, Bm, Cm, A, p["D"], h0=h0,
                               return_state=True)
    else:
        da = torch.exp(dt[..., None] * A[None, None])          # (B,S,d_in,N)
        dbx = dt[..., None] * Bm[:, :, None, :] * xf[..., None]
        h = torch.zeros(B, d_in, N, dtype=torch.float32,
                        device=x_seq.device) if h0 is None else h0
        if impl.startswith("unroll"):
            y, hT = _scan_unrolled(da, dbx, Cm, h,
                                   int(impl[len("unroll"):] or 8))
        elif impl == "chunked":
            y, hT = _scan_chunked(da, dbx, Cm, h, min(s.chunk, S))
        else:
            raise ValueError(f"unknown mamba1 impl {impl!r}")
        y = y + p["D"][None, None] * xf
    y = (y * F.silu(z.float())).to(x_seq.dtype)
    return y @ p["out_proj"], {"ssm": hT, "conv": conv_tail.to(torch.bfloat16)}


def mamba1_decode(p, x_t, state, cfg: ModelConfig):
    """One-token decode.  x_t: (B, 1, d).  state: dict(conv, ssm)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    N = s.d_state
    dt_rank = p["dt_proj"].shape[0]
    xz = x_t[:, 0] @ p["in_proj"]
    x, z = xz[..., :d_in], xz[..., d_in:]
    xc, conv_state = conv1d_step(x, state["conv"], p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    proj = xc @ p["x_proj"]
    dt = F.softplus((proj[..., :dt_rank] @ p["dt_proj"]).float()
                    + p["dt_bias"])                             # (B, d_in)
    Bm = proj[..., dt_rank:dt_rank + N].float()
    Cm = proj[..., dt_rank + N:].float()
    A = -torch.exp(p["A_log"])
    xf = xc.float()
    h = torch.exp(dt[..., None] * A[None]) * state["ssm"] \
        + dt[..., None] * Bm[:, None, :] * xf[..., None]
    y = torch.einsum("bdn,bn->bd", h, Cm) + p["D"][None] * xf
    y = (y * F.silu(z.float())).to(x_t.dtype)
    return (y @ p["out_proj"])[:, None], {"conv": conv_state, "ssm": h}
