"""Tiled matrix product on Hopper: the wrapper of ``csrc/nvdla_matmul.cu``.

The CUDA kernel replaces the Pallas TPU kernel
``repro/kernels/nvdla_matmul.py`` (``_matmul_kernel``) and takes its block
shapes the way it does: ``bm`` x ``bn`` output tiles and ``bk`` of K a step
of the reduction loop, by default the tiling optimizer's
(``repro_torch.core.tiling.choose_matmul_tiling`` at the H100, the
counterpart of ``repro/core/tiling.py``'s).  Each variant instantiates a
few tiles (``tiles(variant)``); a block that is not one of them raises
``ValueError``, here and in ``ops.matmul`` on the CPU alike, and the kernel
refuses it too: no tile stands in for another.  Unlike the Pallas kernel,
which asserts that its blocks divide M, N and K, this one takes any M, N and
K and masks the ragged edges.  The chooser also fixes the tile's pipeline
stages and the split of K over blocks (``splits``, whose float32 partials a
second pass sums), which the TPU's one core, walking its grid in order,
never needs.  This wrapper checks its inputs, makes them contiguous and
16-byte aligned, allocates the output (and the float32 workspace of the
split operands or the partials), launches on PyTorch's current stream and
raises if the launch fails.  It takes CUDA tensors only; the plain version
is ``repro_torch.kernels.ref.matmul_ref`` and ``repro_torch.kernels.ops``
picks between the two by device.

The kernel has variants, one chosen per call by ``variant(M, N, K, dtype)``,
a rule by shape and type.  float32 with M > 16 rows takes ``"tf32x3"``: a
split pass writes each operand as TF32 hi and lo parts (b transposed,
K-major, padded to K % 32 == 0) into a workspace whose size is
``tf32x3_workspace(M, N, K, splits)``, and a ``wgmma`` kernel fed by TMA sums
hi·hi + hi·lo + lo·hi on the tensor cores.  float32 with M <= 16 (decoding
rows) takes ``"stream"``, which reads b once with 16-byte loads.  bf16 with
M > 16 and K, N multiples of 8 (row strides TMA can describe) takes
``"wgmma"``; other bf16 shapes take ``"mma_sync"``.  ``"fma"`` (float32 FMAs
on the CUDA cores) runs only when named.  A failed launch raises; no
variant stands in for another.

``matmul.launches`` counts the kernel's launches (a tf32x3 call's split pass,
product and split-K sum count once) and ``matmul.launches_by_variant``
splits them by variant.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import tiling
from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# variant -> (code in csrc/nvdla_matmul.cu, dtype it takes)
VARIANTS = {"fma": (0, torch.float32), "mma_sync": (1, torch.bfloat16),
            "wgmma": (2, torch.bfloat16), "stream": (3, torch.float32),
            "tf32x3": (4, torch.float32)}
SMALL_M = tiling.SMALL_M   # at most this many rows: the decoding-row variants
TF32_K_ALIGN = 32   # the tf32x3 split operands' rows: one 128-byte TMA row


def variant(M, N, K, dtype):
    """The kernel variant of an (M, K) @ (K, N) product in ``dtype``:
    float32 takes ``"tf32x3"`` for M > 16 and ``"stream"`` otherwise, for
    any K and N; bf16 takes ``"wgmma"`` for M > 16 and K % 8 == N % 8 == 0,
    ``"mma_sync"`` otherwise (``tiling.hopper_variant``).  Raises on another
    type."""
    if dtype not in _DTYPES:
        raise TypeError(f"matmul kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    return tiling.hopper_variant(M, N, K, dtype.itemsize)


def tiles(name):
    """The (bm, bn, bk) tiles variant ``name`` instantiates, in the order
    the chooser breaks ties."""
    return [t[:3] for t in tiling.matmul_kernel(name).tiles]


def tf32x3_workspace(M, N, K, splits=1):
    """float32 elements of the tf32x3 variant's workspace: a_hi, a_lo as
    (M, Kp) and bT_hi, bT_lo as (N, Kp), with Kp = K rounded up to 32, and
    behind them the (splits, M, N) partials where K is split.  The kernel's
    ``nvdla_matmul_workspace`` computes the same and refuses a shorter
    workspace."""
    kp = -(-K // TF32_K_ALIGN) * TF32_K_ALIGN
    return 2 * kp * (M + N) + (splits * M * N if splits > 1 else 0)


def _takes(name, M, N, K, dtype):
    """Whether variant ``name`` takes an (M, N, K) product in ``dtype``."""
    if name not in VARIANTS or VARIANTS[name][1] != dtype:
        return False
    if name == "wgmma":
        return K % 8 == 0 and N % 8 == 0
    return name != "stream" or M <= SMALL_M


@functools.lru_cache(maxsize=4096)
def tiling_of(M, N, K, dtype, *, bm=0, bn=0, bk=0, splits=0, kernel=None):
    """The :class:`~repro_torch.core.tiling.MatmulTiling` a call takes: the
    variant ``kernel`` (default ``variant``'s), the chooser's tile where any
    of ``bm``, ``bn``, ``bk`` is 0 (as the reference's ``matmul``) and else
    that tile, and ``splits`` blocks over K where it is not 0 (else the
    chooser's for the tile).  Raises ``ValueError`` for a variant that does
    not take the inputs, a tile it does not instantiate, or a split count
    its k ranges cannot give.  Cached by its arguments: the wrapper asks on
    every call."""
    name = variant(M, N, K, dtype) if kernel is None else kernel
    if not _takes(name, M, N, K, dtype):
        raise ValueError(f"kernel variant {name!r} does not take {dtype} "
                         f"at (M, N, K) = {(M, N, K)}")
    block = (bm, bn, bk) if bm and bn and bk else None
    if block and block not in tiles(name):
        raise ValueError(f"matmul variant {name!r} has no tile (bm, bn, bk) "
                         f"= {block}; it instantiates {tiles(name)}")
    t = tiling.choose_matmul_tiling(M, N, K, dtype.itemsize, variant=name,
                                    block=block)
    if splits and splits != t.splits:
        kern = tiling.matmul_kernel(name)
        if splits > 1 and (not kern.split_depth or tiling.aligned_splits(
                K, splits, kern.split_align) != splits):
            raise ValueError(
                f"matmul variant {name!r} cannot split K = {K} over "
                f"{splits} blocks (k ranges multiples of "
                f"{kern.split_align}; wgmma never splits)")
        t = dataclasses.replace(t, splits=splits)
    return t


@functools.cache
def _lib():
    lib = _build.load("nvdla_matmul")
    lib.nvdla_matmul.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.nvdla_matmul.restype = ctypes.c_int
    lib.nvdla_matmul_workspace.argtypes = [ctypes.c_int] * 5
    lib.nvdla_matmul_workspace.restype = ctypes.c_longlong
    return lib


def matmul(a, b, *, bm=0, bn=0, bk=0, splits=0, kernel=None):
    """a: (M, K) @ b: (K, N) -> (M, N) in a's dtype, float32 accumulation.
    Both on one CUDA device, both float32 or both bfloat16.  ``bm``, ``bn``,
    ``bk``: the output tile's rows and columns and K a step, one of
    ``tiles(variant)``; all three 0 (or any one, as in the reference) takes
    the tiling optimizer's.  ``splits``: blocks K is split over, 0 for the
    chooser's at the tile.  ``kernel`` names a variant other than
    ``variant(M, N, K, dtype)`` (to time one against another); it must take
    the inputs' type (and, for ``"wgmma"``, K and N multiples of 8; for
    ``"stream"``, M <= 16).  ``tiling_of`` says what raises."""
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
    t = tiling_of(M, N, K, a.dtype, bm=bm, bn=bn, bk=bk, splits=splits,
                  kernel=kernel)
    # contiguous, and 16-byte aligned for the kernels' vector loads
    a, b = (x if x.data_ptr() % 16 == 0 else x.clone()
            for x in (a.contiguous(), b.contiguous()))
    lib = _lib()
    out = torch.empty(M, N, dtype=a.dtype, device=a.device)
    code = VARIANTS[t.variant][0]
    # the split operands and the split-K partials (the kernel refuses a
    # workspace shorter than it needs)
    n_ws = lib.nvdla_matmul_workspace(M, N, K, code, t.splits)
    ws = torch.empty(n_ws, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = lib.nvdla_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              ws.data_ptr() if n_ws else None, n_ws, M, N, K,
                              _DTYPES[a.dtype], code, t.bm, t.bn, t.bk,
                              t.splits, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"matmul kernel launch failed: cudaError_t {rc} "
                           f"({t.variant} tile {(t.bm, t.bn, t.bk)}, "
                           f"{t.splits} splits)")
    matmul.launches += 1
    matmul.launches_by_variant[t.variant] += 1
    return out


def reset_counts():
    """Sets ``launches`` and every ``launches_by_variant`` count to 0."""
    matmul.launches = 0
    matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)


reset_counts()
