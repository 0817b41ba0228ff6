"""Plain PyTorch versions of the port's kernels.

They compute what the CUDA kernels compute, in float32 on any device.  The
CPU path of ``repro_torch.kernels.ops`` runs them, and the tests and
``chip_smoke.py`` hold each kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan import check_state

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D) with ``H % Hkv == 0``.

    Dense softmax attention with scale ``D**-0.5``, the causal mask
    ``qpos >= kpos`` and, for ``window > 0``, the sliding-window mask
    ``qpos - kpos < window``.  KV stays at its native ``Hkv`` heads: the
    query heads are grouped onto it.  Returns (B, H, S, D) in q's dtype.
    """
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if k.shape[2] != S:
        raise ValueError(f"k's length {k.shape[2]} differs from q's {S}: "
                         f"flash attention takes one sequence length")
    qg = q.float().reshape(B, Hkv, H // Hkv, S, D)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, k.float()) * (D ** -0.5)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
    return out.reshape(B, H, S, D).to(q.dtype)


def matmul_ref(a, b):
    """a: (M, K) @ b: (K, N) -> (M, N): the product in float32, cast to
    a's dtype.  On the card, float32 products run in full float32 only
    while ``torch.backends.cuda.matmul.allow_tf32`` is False (the default)."""
    return (a.float() @ b.float()).to(a.dtype)


def mamba_scan_ref(x, dt, B, C, A, D, h0=None, return_state=False):
    """Mamba1 selective scan, a sequential loop over time in float32.

    x, dt: (b, S, d); B, C: (b, S, N); A: (d, N); D: (d,).  With the state
    h (b, d, N) starting at ``h0`` ((b, d, N) float32; 0 if None), each step
    computes ``h = exp(dt_t A) h + (dt_t x_t) B_t`` and
    ``y_t = sum_n h C_t + D x_t``.  Returns y: (b, S, d) in x's dtype, and
    with ``return_state`` the pair (y, h_S), h_S the final state.
    """
    bsz, S, d = x.shape
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    A = A.float()
    if h0 is None:
        h = torch.zeros(bsz, d, B.shape[-1], dtype=torch.float32,
                        device=x.device)
    else:
        check_state(h0, x, B.shape[-1])
        h = h0
    ys = []
    for t in range(S):
        dt_t = dtf[:, t, :, None]                                   # (b, d, 1)
        h = torch.exp(dt_t * A) * h \
            + (dt_t * xf[:, t, :, None]) * Bf[:, t, None, :]
        ys.append((h * Cf[:, t, None, :]).sum(-1))
    y = (torch.stack(ys, 1) + D.float() * xf).to(x.dtype)
    return (y, h) if return_state else y
