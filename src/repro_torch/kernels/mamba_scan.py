"""Mamba1 selective scan on Hopper: the wrapper of ``csrc/mamba_scan.cu``.

The CUDA kernel replaces the Pallas TPU kernel ``repro/kernels/mamba_scan.py``
(``_scan_kernel``).  It takes any S and d; its block shapes are its own (the
Pallas ``bd`` and ``chunk`` have no counterpart).  Beyond the Pallas kernel
it takes a starting state ``h0`` and returns the final state on request,
as the model's ``mamba1_forward`` needs.  This wrapper checks its inputs,
makes them contiguous, allocates the outputs, launches on PyTorch's current
stream and raises if the launch fails.  It takes CUDA tensors only;
the plain version is ``repro_torch.kernels.ref.mamba_scan_ref`` and
``repro_torch.kernels.ops`` picks between the two by device.

The wrapper raises when autograd is recording and an input requires grad
(``_build.refuse_grad``): ``repro_torch.kernels.ops.mamba_scan`` is the
differentiable entry point.

``mamba_scan.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

STATE_DIMS = (8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel():
    fn = _build.load("mamba_scan").mamba_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_state(h0, x, N):
    """Raises unless ``h0`` is a (b, d, N) float32 state on x's device; the
    plain version makes the same check."""
    bsz, _, d = x.shape
    if h0.shape != (bsz, d, N) or h0.dtype != torch.float32 \
            or h0.device != x.device:
        raise ValueError(f"h0 must be ({bsz}, {d}, {N}) float32 on "
                         f"{x.device}, got {tuple(h0.shape)} {h0.dtype} on "
                         f"{h0.device}")


def mamba_scan(x, dt, B, C, A, D, h0=None, return_state=False):
    """x, dt: (b, S, d); B, C: (b, S, N), all float32 or all bfloat16;
    A: (d, N) float32; D: (d,) float32; N in ``STATE_DIMS``; all on one CUDA
    device.  ``h0``: the starting state, (b, d, N) float32, zeros if None.
    Returns y: (b, S, d) in x's dtype, and with ``return_state`` the pair
    (y, h_S), h_S the final state (b, d, N) float32."""
    ts = (x, dt, B, C, A, D)
    _build.refuse_grad("mamba_scan", *ts, h0)
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError("mamba_scan kernel takes x, dt, B, C, A, D on one "
                         f"CUDA device, got {[str(t.device) for t in ts]}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, B, C)) \
            or A.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError("mamba_scan kernel takes x, dt, B, C float32 or "
                        "bfloat16 of one type and A, D float32, got "
                        f"{[t.dtype for t in ts]}")
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty (b, S, d), got "
                         f"{tuple(x.shape)}")
    bsz, S, d = x.shape
    N = B.shape[-1] if B.dim() == 3 else -1
    if dt.shape != x.shape or B.shape != (bsz, S, N) or C.shape != B.shape \
            or A.shape != (d, N) or D.shape != (d,):
        raise ValueError("mamba_scan takes x, dt (b, S, d), B, C (b, S, N), "
                         "A (d, N), D (d,), got "
                         f"{[tuple(t.shape) for t in ts]}")
    if N not in STATE_DIMS:
        raise ValueError(f"state dim N={N} not in {STATE_DIMS}")
    if h0 is not None:
        check_state(h0, x, N)
        h0 = h0.contiguous()
    x, dt, B, C, A, D = (t.contiguous() for t in ts)
    y = torch.empty_like(x)
    hT = torch.empty(bsz, d, N, dtype=torch.float32, device=x.device) \
        if return_state else None
    with torch.cuda.device(x.device):
        rc = _kernel()(x.data_ptr(), dt.data_ptr(), B.data_ptr(),
                       C.data_ptr(), A.data_ptr(), D.data_ptr(),
                       None if h0 is None else h0.data_ptr(), y.data_ptr(),
                       None if hT is None else hT.data_ptr(),
                       bsz, S, d, N, _DTYPES[x.dtype],
                       torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"mamba_scan kernel launch failed: cudaError_t "
                           f"{rc}")
    mamba_scan.launches += 1
    return (y, hT) if return_state else y


mamba_scan.launches = 0
