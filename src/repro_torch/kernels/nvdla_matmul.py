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
a rule by shape and type.  float32 with M > 16 rows takes ``"tf32x3"``: a
split pass writes each operand as TF32 hi and lo parts (b transposed,
K-major, padded to K % 32 == 0) into a workspace whose size is
``tf32x3_workspace(M, N, K)``, and a ``wgmma`` kernel fed by TMA sums
hi·hi + hi·lo + lo·hi on the tensor cores.  float32 with M <= 16 (decoding
rows) takes ``"stream"``, which reads b once with 16-byte loads and splits K
when its columns are few.  bf16 with M > 16 and K, N multiples of 8 (row
strides TMA can describe) takes ``"wgmma"``; other bf16 shapes take
``"mma_sync"``, which splits K when its output tiles are few.  ``"fma"``
(float32 FMAs on the CUDA cores) runs only when named.  A failed launch
raises; no variant stands in for another.

``matmul.launches`` counts the kernel's launches (a tf32x3 call's split pass
and product count once) and ``matmul.launches_by_variant`` splits them by
variant.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# variant -> (code in csrc/nvdla_matmul.cu, dtype it takes)
VARIANTS = {"fma": (0, torch.float32), "mma_sync": (1, torch.bfloat16),
            "wgmma": (2, torch.bfloat16), "stream": (3, torch.float32),
            "tf32x3": (4, torch.float32)}
SMALL_M = 16   # at most this many rows: the decoding-row variants
TF32_K_ALIGN = 32   # the tf32x3 split operands' rows: one 128-byte TMA row


def variant(M, N, K, dtype):
    """The kernel variant of an (M, K) @ (K, N) product in ``dtype``:
    float32 takes ``"tf32x3"`` for M > 16 and ``"stream"`` otherwise, for
    any K and N; bf16 takes ``"wgmma"`` for M > 16 and K % 8 == N % 8 == 0,
    ``"mma_sync"`` otherwise.  Raises on another type."""
    if dtype not in _DTYPES:
        raise TypeError(f"matmul kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    if dtype == torch.float32:
        return "tf32x3" if M > SMALL_M else "stream"
    return "wgmma" if M > SMALL_M and K % 8 == 0 and N % 8 == 0 \
        else "mma_sync"


def tf32x3_workspace(M, N, K):
    """float32 elements of the tf32x3 variant's workspace: a_hi, a_lo as
    (M, Kp) and bT_hi, bT_lo as (N, Kp), with Kp = K rounded up to 32.  The
    kernel's ``nvdla_matmul_workspace`` computes the same and refuses a
    shorter workspace."""
    kp = -(-K // TF32_K_ALIGN) * TF32_K_ALIGN
    return 2 * kp * (M + N)


def _takes(name, M, N, K, dtype):
    """Whether variant ``name`` takes an (M, N, K) product in ``dtype``."""
    if name not in VARIANTS or VARIANTS[name][1] != dtype:
        return False
    if name == "wgmma":
        return K % 8 == 0 and N % 8 == 0
    return name != "stream" or M <= SMALL_M


@functools.cache
def _lib():
    lib = _build.load("nvdla_matmul")
    lib.nvdla_matmul.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.nvdla_matmul.restype = ctypes.c_int
    lib.nvdla_matmul_workspace.argtypes = [ctypes.c_int] * 4
    lib.nvdla_matmul_workspace.restype = ctypes.c_longlong
    return lib


def matmul(a, b, *, kernel=None):
    """a: (M, K) @ b: (K, N) -> (M, N) in a's dtype, float32 accumulation.
    Both on one CUDA device, both float32 or both bfloat16.  ``kernel``
    names a variant other than ``variant(M, N, K, dtype)`` (to time one
    against another); it must take the inputs' type (and, for ``"wgmma"``,
    K and N multiples of 8; for ``"stream"``, M <= 16)."""
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
    if not _takes(name, M, N, K, a.dtype):
        raise ValueError(f"kernel variant {name!r} does not take {a.dtype} "
                         f"at (M, N, K) = {(M, N, K)}")
    # contiguous, and 16-byte aligned for the kernels' vector loads
    a, b = (t if t.data_ptr() % 16 == 0 else t.clone()
            for t in (a.contiguous(), b.contiguous()))
    lib = _lib()
    out = torch.empty(M, N, dtype=a.dtype, device=a.device)
    code = VARIANTS[name][0]
    # the split operands, or float32 partials when the kernel splits K (the
    # kernel refuses a workspace shorter than it needs)
    n_ws = tf32x3_workspace(M, N, K) if name == "tf32x3" \
        else lib.nvdla_matmul_workspace(M, N, K, code)
    ws = torch.empty(n_ws, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = lib.nvdla_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              ws.data_ptr() if n_ws else None, n_ws, M, N, K,
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
