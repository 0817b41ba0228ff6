"""Tiled matrix product on Hopper: the wrapper of ``csrc/nvdla_matmul.cu``.

The CUDA kernel replaces the Pallas TPU kernel
``repro/kernels/nvdla_matmul.py`` (``_matmul_kernel``).  It takes any M, N
and K and masks the ragged edges; the Pallas block shapes (``bm``, ``bn``,
``bk``) and the TPU tiling chooser (``repro/core/tiling.py::
choose_matmul_tiling``, v5e MXU and VMEM sizes) have no counterpart here:
the kernel's tiles are its own.  This wrapper checks its
inputs, makes them contiguous and 16-byte aligned, allocates the output (and
the float32 workspace of a product whose K the kernel splits over blocks),
launches on PyTorch's current stream and raises if the launch fails.  It takes
CUDA tensors only; the plain version is ``repro_torch.kernels.ref.matmul_ref``
and ``repro_torch.kernels.ops`` picks between the two by device.

The kernel has variants, one chosen per call by ``variant(M, N, K, dtype)``,
a rule by shape and type: bf16 with M > 16 rows and K, N multiples of 8
(row strides TMA can describe) takes the Hopper kernel (``"wgmma"``: wgmma
fed by TMA); other bf16 shapes, the decoding ones among them, take the
``mma.sync`` kernel, which splits K when its output tiles are few; float32
takes the FMA kernel.  A failed launch raises; no variant stands in for
another.

``matmul.launches`` counts the kernel's launches and
``matmul.launches_by_variant`` splits them by variant.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# variant -> (code in csrc/nvdla_matmul.cu, dtype it takes)
VARIANTS = {"fma": (0, torch.float32), "mma_sync": (1, torch.bfloat16),
            "wgmma": (2, torch.bfloat16)}
SMALL_M = 16   # at most this many rows: the mma.sync kernel's 16-row tiles


def variant(M, N, K, dtype):
    """The kernel variant of an (M, K) @ (K, N) product in ``dtype``:
    ``"wgmma"`` for bf16 with M > 16 and K % 8 == N % 8 == 0, ``"mma_sync"``
    for other bf16 shapes, ``"fma"`` for float32.  Raises on another type."""
    if dtype not in _DTYPES:
        raise TypeError(f"matmul kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if M > SMALL_M and K % 8 == 0 and N % 8 == 0 \
        else "mma_sync"


@functools.cache
def _lib():
    lib = _build.load("nvdla_matmul")
    lib.nvdla_matmul.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.nvdla_matmul.restype = ctypes.c_int
    lib.nvdla_matmul_splits.argtypes = [ctypes.c_int] * 4
    lib.nvdla_matmul_splits.restype = ctypes.c_int
    return lib


def matmul(a, b, *, kernel=None):
    """a: (M, K) @ b: (K, N) -> (M, N) in a's dtype, float32 accumulation.
    Both on one CUDA device, both float32 or both bfloat16.  ``kernel``
    names a variant other than ``variant(M, N, K, dtype)`` (to time one
    against another); it must take the inputs' type (and, for ``"wgmma"``,
    K and N multiples of 8)."""
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("matmul kernel takes a, b on one CUDA device, got "
                         f"{a.device}, {b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError("matmul kernel takes float32 or bfloat16 a, b of one "
                        f"type, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] \
            or 0 in a.shape or 0 in b.shape:
        raise ValueError(f"matmul takes non-empty (M, K) and (K, N), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    (M, K), N = a.shape, b.shape[1]
    name = variant(M, N, K, a.dtype) if kernel is None else kernel
    if name not in VARIANTS or VARIANTS[name][1] != a.dtype or (
            name == "wgmma" and (K % 8 or N % 8)):
        raise ValueError(f"kernel variant {name!r} does not take {a.dtype} "
                         f"at (M, N, K) = {(M, N, K)}")
    # contiguous, and 16-byte aligned for the bf16 kernel's vector loads
    a, b = (t if t.data_ptr() % 16 == 0 else t.clone()
            for t in (a.contiguous(), b.contiguous()))
    lib = _lib()
    out = torch.empty(M, N, dtype=a.dtype, device=a.device)
    # float32 partials when the kernel splits K over blocks
    code = VARIANTS[name][0]
    splits = lib.nvdla_matmul_splits(M, N, K, code)
    ws = torch.empty(splits * M * N if splits > 1 else 0,
                     dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = lib.nvdla_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              ws.data_ptr() if splits > 1 else None, M, N, K,
                              _DTYPES[a.dtype], code,
                              torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"matmul kernel launch failed: cudaError_t {rc}")
    matmul.launches += 1
    matmul.launches_by_variant[name] += 1
    return out


def reset_counts():
    """Sets ``launches`` and every ``launches_by_variant`` count to 0."""
    matmul.launches = 0
    matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)


reset_counts()
