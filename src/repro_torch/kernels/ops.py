"""Public entry points of the port's kernels, dispatched by device.

A CPU tensor takes the plain PyTorch version (``repro_torch.kernels.ref``).
A CUDA tensor launches the hand-written kernel, or raises if its build or its
launch fails: there is no fallback from the card to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D).  KV stays at its native
    ``Hkv`` heads on both paths."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type == "cuda":
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention: no implementation for device "
                     f"{q.device}")
