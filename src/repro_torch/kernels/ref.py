"""Plain PyTorch versions of the port's kernels.

They compute what the CUDA kernels compute, in float32 on any device.  The
CPU path of ``repro_torch.kernels.ops`` runs them, and the tests and
``chip_smoke.py`` hold each kernel against them on the card.
"""
from __future__ import annotations

import torch

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
