"""Flash attention on Hopper: the wrapper of ``csrc/flash_attention.cu``.

The CUDA kernel replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py`` (``_flash_kernel``).  This wrapper
checks its inputs, allocates the output, launches on PyTorch's current
stream and raises if the launch fails.  It takes CUDA tensors only; the plain
version is ``repro_torch.kernels.ref.flash_attention_ref`` and
``repro_torch.kernels.ops`` picks between the two by device.

The kernel has variants, one chosen per call by ``variant(D, dtype)``, a
rule by type.  bf16 takes ``"wgmma"`` (wgmma fed by TMA) and float32 takes
``"tf32x3"``: a split pass writes q, k and v transposed as TF32 hi and lo
parts into a workspace whose length the library's
``flash_attention_workspace`` gives, and a wgmma kernel fed by TMA sums
hi·hi + hi·lo + lo·hi for both products.  Both take every head dim of
``HEAD_DIMS``; at 16, 32, 80 and 96 a row is padded to whole 128-byte TMA
boxes with zeros that no product reads (80, zamba2's shared attention:
two bf16 boxes of 64 columns, three fp32 boxes of 32), and 192 (MLA's q/k
width) is three whole boxes.  The card's times put them ahead of the
older kernels at every head dim (PERF.md), which run when named:
``mma.sync`` (bf16, ``"mma_sync"``) and FMAs on the CUDA cores (float32,
``"fma"``), at the head dims they were built for (``VARIANT_HEAD_DIMS``:
not 80 or 192).  A
variant named off its head dims raises before the launch, and a failed
launch raises; no variant stands in for another.

The wrapper raises when autograd is recording and an input requires grad
(``_build.refuse_grad``): ``repro_torch.kernels.ops.flash_attention`` is
the differentiable entry point.

``flash_attention.launches`` counts the kernel's launches (a tf32x3 call's
split pass and product count once) and
``flash_attention.launches_by_variant`` splits them by variant.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 80, 96, 128, 192, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# variant -> (code in csrc/flash_attention.cu, dtype it takes)
VARIANTS = {"fma": (0, torch.float32), "mma_sync": (1, torch.bfloat16),
            "wgmma": (2, torch.bfloat16), "tf32x3": (3, torch.float32)}
# the head dims each variant is built for: the older kernels predate 80
# and 192
_OLDER = tuple(D for D in HEAD_DIMS if D not in (80, 192))
VARIANT_HEAD_DIMS = {"fma": _OLDER, "mma_sync": _OLDER,
                     "wgmma": HEAD_DIMS, "tf32x3": HEAD_DIMS}


def variant(D, dtype):
    """The kernel variant for head dim ``D`` and ``dtype``: ``"wgmma"`` for
    bf16 and ``"tf32x3"`` for float32 at every head dim.  Raises on a head
    dim or type the kernel lacks."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    return "tf32x3" if dtype == torch.float32 else "wgmma"


@functools.cache
def _lib():
    lib = _build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_longlong] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_workspace.argtypes = [ctypes.c_int] * 5
    lib.flash_attention_workspace.restype = ctypes.c_longlong
    return lib


def flash_attention(q, k, v, *, causal=True, window=0, kernel=None):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D) with ``H % Hkv == 0``, all on
    one CUDA device, all float32 or all bfloat16.  ``window > 0`` adds the
    sliding-window mask ``qpos - kpos < window``.  ``kernel`` names a
    variant other than ``variant(D, dtype)`` (to time one against another);
    it must take the inputs' type.
    Returns (B, H, S, D)."""
    _build.refuse_grad("flash_attention", q, k, v)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel takes q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one type, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be 4-d with k.shape == v.shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if Hkv == 0 or H % Hkv or (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D):
        raise ValueError(f"k, v must be (B, Hkv, S, D) with H % Hkv == 0 for "
                         f"q {tuple(q.shape)}, got {tuple(k.shape)}")
    name = variant(D, q.dtype)   # raises on a head dim the kernel lacks
    if kernel is not None:
        name = kernel
    if name not in VARIANTS or VARIANTS[name][1] != q.dtype:
        raise ValueError(f"kernel variant {name!r} does not take "
                         f"{q.dtype}")
    if D not in VARIANT_HEAD_DIMS[name]:
        raise ValueError(f"kernel variant {name!r} is not built for head "
                         f"dim {D}; it takes {VARIANT_HEAD_DIMS[name]}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    # contiguous, and 16-byte aligned for the bf16 kernel's vector loads
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
               for t in (q.contiguous(), k.contiguous(), v.contiguous()))
    lib = _lib()
    out = torch.empty_like(q)
    # the split operands of tf32x3 (the kernel refuses a shorter workspace)
    ws, n_ws = None, 0
    if name == "tf32x3":
        n_ws = lib.flash_attention_workspace(B, H, Hkv, S, D)
        ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), n_ws, B, H, Hkv, S, D,
            int(causal), int(window), _DTYPES[q.dtype], VARIANTS[name][0],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {rc}")
    flash_attention.launches += 1
    flash_attention.launches_by_variant[name] += 1
    return out


def reset_counts():
    """Sets ``launches`` and every ``launches_by_variant`` count to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)


reset_counts()
