"""Public entry points of the port's kernels, dispatched by device.

A CPU tensor takes the plain PyTorch version (``repro_torch.kernels.ref``).
A CUDA tensor launches the hand-written kernel, or raises if its build or its
launch fails: there is no fallback from the card to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import nvdla_matmul as _matmul
from repro_torch.kernels import ref


def _dispatch(name, plain, kernel, device, *args, **kw):
    if device.type == "cpu":
        return plain(*args, **kw)
    if device.type == "cuda":
        return kernel(*args, **kw)
    raise ValueError(f"{name}: no implementation for device {device}")


def matmul(a, b):
    """a: (M, K) @ b: (K, N) -> (M, N) in a's dtype, float32 accumulation."""
    return _dispatch("matmul", ref.matmul_ref, _matmul.matmul, a.device, a, b)


def flash_attention(q, k, v, *, causal=True, window=0):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D).  KV stays at its native
    ``Hkv`` heads on both paths."""
    return _dispatch("flash_attention", ref.flash_attention_ref,
                     _flash.flash_attention, q.device, q, k, v,
                     causal=causal, window=window)


def mamba_scan(x, dt, B, C, A, D, h0=None, return_state=False):
    """x, dt: (b, S, d); B, C: (b, S, N); A: (d, N) and D: (d,) float32;
    h0: the starting state (b, d, N) float32, zeros if None.  Returns y:
    (b, S, d) in x's dtype, and with ``return_state`` the pair (y, h_S),
    h_S the final state (b, d, N) float32."""
    return _dispatch("mamba_scan", ref.mamba_scan_ref, _mamba.mamba_scan,
                     x.device, x, dt, B, C, A, D, h0=h0,
                     return_state=return_state)
