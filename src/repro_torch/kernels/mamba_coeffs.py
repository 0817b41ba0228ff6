"""The Mamba1 mixer's coefficients on Hopper: the wrapper of
``csrc/mamba_coeffs.cu``.

Two kernels of ``models/ssm.py::_ssm_coeffs1``'s elementwise work, which
replace no TPU kernel (the JAX package leaves the chain to XLA):

- ``conv1d_silu(x, w, b)``: the causal depthwise conv, its bias and silu,
  summed and taken in float32 and rounded once to bf16, with that result's
  float32 widening for the scan.  x is read where it lies: the first
  ``d_in`` columns of the ``in_proj`` product, whose rows are ``2 d_in``
  apart, with no copy;
- ``dt_softplus(p, bias)``: ``softplus(float(p) + bias)`` in float32.

Each wrapper checks its inputs, allocates the outputs, launches on
PyTorch's current stream and raises if the launch fails.  It takes bf16
CUDA tensors only (``dt_softplus``'s bias float32), and checks type and
shape before the device, so that a CPU tensor of the wrong type or shape
is refused for that.  The plain versions are
``repro_torch.kernels.ref.conv1d_silu_ref`` and ``dt_softplus_ref``, and
``repro_torch.kernels.ops`` picks between the two by device.  The wrappers
raise when autograd is recording and an input requires grad
(``_build.refuse_grad``): ``ops`` holds the differentiable entry points.

``conv1d_silu.launches`` and ``dt_softplus.launches`` count the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

K_MAX = 4   # the conv's largest kernel width (csrc: K_MAX)
_VEC = 8    # bf16 channels a thread reads as one 16-byte vector


@functools.cache
def _lib():
    lib = _build.load("mamba_coeffs")
    lib.conv1d_silu_fwd.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_longlong] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.conv1d_silu_fwd.restype = ctypes.c_int
    lib.dt_softplus_fwd.argtypes = [ctypes.c_void_p] * 3 \
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.dt_softplus_fwd.restype = ctypes.c_int
    return lib


def conv1d_silu(x, w, b):
    """x: (b, S, d) bf16 with unit channel stride and any row and batch
    strides (``xz[..., :d]``); w: (d, k) bf16, 1 <= k <= ``K_MAX``; b: (d,)
    bf16; all on one CUDA device.  Returns (y, yf): y = silu(causal conv of
    x with w, plus b) rounded once to bf16, (b, S, d) contiguous, and yf its
    float32 widening."""
    _build.refuse_grad("conv1d_silu", x, w, b)
    if any(t.dtype != torch.bfloat16 for t in (x, w, b)):
        raise TypeError("conv1d_silu kernel takes x, w, b bfloat16, got "
                        f"{[t.dtype for t in (x, w, b)]}")
    if x.dim() != 3 or 0 in x.shape or w.dim() != 2 \
            or w.shape[0] != x.shape[2] or b.shape != (x.shape[2],):
        raise ValueError("conv1d_silu takes x (b, S, d), w (d, k), b (d,), "
                         f"got {[tuple(t.shape) for t in (x, w, b)]}")
    k = w.shape[1]
    if not 1 <= k <= K_MAX:
        raise ValueError(f"conv1d_silu kernel takes a conv width k of 1 to "
                         f"{K_MAX}, got {k}")
    _build.on_card("conv1d_silu", x, w, b)
    if x.stride(2) != 1:
        x = x.contiguous()
    w, b = w.contiguous(), b.contiguous()
    bsz, S, d = x.shape
    vec = _VEC if d % _VEC == 0 and x.stride(0) % _VEC == 0 \
        and x.stride(1) % _VEC == 0 and _build.aligned(x) else 1
    y = torch.empty(bsz, S, d, dtype=torch.bfloat16, device=x.device)
    yf = torch.empty(bsz, S, d, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().conv1d_silu_fwd(
            x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(),
            b.data_ptr(), y.data_ptr(), yf.data_ptr(), bsz, S, d, k, vec,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"conv1d_silu kernel launch failed: cudaError_t "
                           f"{rc} (x {tuple(x.shape)}, k {k}, vec {vec})")
    conv1d_silu.launches += 1
    return y, yf


def dt_softplus(p, bias):
    """p: (..., d) bf16; bias: (d,) float32; on one CUDA device.  Returns
    softplus(float(p) + bias), float32, p's shape (beta 1, threshold 20, as
    ``F.softplus``)."""
    _build.refuse_grad("dt_softplus", p, bias)
    if p.dtype != torch.bfloat16 or bias.dtype != torch.float32:
        raise TypeError("dt_softplus kernel takes p bfloat16 and bias "
                        f"float32, got {p.dtype}, {bias.dtype}")
    if p.dim() < 1 or p.numel() == 0 or bias.shape != (p.shape[-1],):
        raise ValueError("dt_softplus takes p (..., d) and bias (d,), got "
                         f"{tuple(p.shape)}, {tuple(bias.shape)}")
    _build.on_card("dt_softplus", p, bias)
    p, bias = p.contiguous(), bias.contiguous()
    d = p.shape[-1]
    out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    vec = _VEC if d % _VEC == 0 and _build.aligned(p) else 1
    with torch.cuda.device(p.device):
        rc = _lib().dt_softplus_fwd(
            p.data_ptr(), bias.data_ptr(), out.data_ptr(), p.numel(), d, vec,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"dt_softplus kernel launch failed: cudaError_t "
                           f"{rc} (p {tuple(p.shape)}, vec {vec})")
    dt_softplus.launches += 1
    return out


conv1d_silu.launches = 0
dt_softplus.launches = 0
