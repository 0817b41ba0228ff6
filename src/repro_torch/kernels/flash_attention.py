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

The caller picks a block's tile, ``bq`` query rows by ``bk`` keys, as the
reference's caller does; 0, 0 takes the variant's default.  The Hopper
variants instantiate, at every head dim, bq 64 or 128 (two warpgroups) by
bk 32, 64 or 128 wherever the block fits the card's shared memory, and the
default; the older ones their one tile (``tiles(variant, D)``).  A tile
that is not one of them raises ``ValueError`` (``tile_of``), here and in
``ops.flash_attention`` on the CPU alike, and the library refuses it too:
no tile stands in for another.  Unlike the reference, which clips bq and bk
to S and asserts that they divide S, the kernel takes the named tile as it
is for any S and masks the ragged edge.  There is no chooser: the reference
has none for attention, and its callers that pass no tile get the default.

The wrapper raises when autograd is recording and an input requires grad
(``_build.refuse_grad``): ``repro_torch.kernels.ops.flash_attention`` is
the differentiable entry point.

``flash_attention.launches`` counts the kernel's launches (a tf32x3 call's
split pass and product count once) and
``flash_attention.launches_by_variant`` splits them by variant.
"""
from __future__ import annotations

import ctypes
import dataclasses
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
# the Hopper variants' tiles: query rows (64 a warpgroup) by keys, where
# the block's shared memory fits the card's 232,448 bytes a block
TILE_BQ = (64, 128)
TILE_BK = (32, 64, 128)
SMEM_MAX = 232448


@dataclasses.dataclass(frozen=True)
class FlashTile:
    """The instance a call launches: ``variant`` at a ``bq`` x ``bk`` tile,
    with its ring's ``stages``, its dynamic ``smem_bytes`` and its block's
    ``threads``, as ``csrc/flash_attention.cuh`` lays it out."""
    variant: str
    bq: int
    bk: int
    stages: int
    smem_bytes: int
    threads: int


def _layout(name, D, bq, bk):
    """(stages, shared bytes, threads) of variant ``name`` at head dim
    ``D`` and tile (bq, bk), as the kernel's ``Tiles*`` structs compute
    them; stages 0 where tf32x3's block has no room for a 2-stage ring."""
    if name == "wgmma":   # Q, one stage of K and one of V, in 64-column boxes
        dp = -(-D // 64) * 64
        return 1, 1024 + 2 * dp * (bq + 2 * bk) + 4 * 8, 2 * bq
    if name == "tf32x3":   # Q and P hi/lo, a ring of K/V^T items, 32 columns
        dp = -(-D // 32) * 32
        most = 4 if D <= 64 else 3 if D <= 128 else 2

        def size(stages):
            return (1024 + 8 * bq * dp + stages * 4 * bk * dp + 8 * bq * bk
                    + 12 * stages + 8)
        stages = next((s for s in (most, most - 1, most - 2)
                       if s >= 2 and size(s) <= SMEM_MAX), 0)
        return stages, size(max(stages, 2)), 2 * bq
    if name == "fma":   # Q, K padded to D + 1, V, P padded to bk + 1
        return 1, 4 * (bq * (D + 1) + bk * (D + 1) + bk * D
                       + bq * (bk + 1)), 256
    return 1, 2 * (bq + 2 * bk) * (D + 8), 128   # mma_sync, rows of D + 8


def default_tile(name, D):
    """The tile a call of variant ``name`` at head dim ``D`` takes with bq =
    bk = 0: 64 x 64, or 64 x 32 above D 128 for tf32x3 and the older
    kernels."""
    return 64, 32 if D > 128 and name != "wgmma" else 64


def _fits(name, D, bq, bk):
    stages, smem, _ = _layout(name, D, bq, bk)
    return stages > 0 and smem <= SMEM_MAX


@functools.cache
def tiles(name, D):
    """The (bq, bk) tiles variant ``name`` instantiates at head dim ``D``,
    the default first: for the Hopper variants, every one of ``TILE_BQ`` x
    ``TILE_BK`` whose block fits in shared memory; the older kernels only
    their default.  Empty off the variant's head dims."""
    if name not in VARIANTS or D not in VARIANT_HEAD_DIMS[name]:
        return ()
    first = default_tile(name, D)
    if name not in ("wgmma", "tf32x3"):
        return (first,)
    return (first, *((bq, bk) for bq in TILE_BQ for bk in TILE_BK
                     if (bq, bk) != first and _fits(name, D, bq, bk)))


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
        + [ctypes.c_longlong] + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_workspace.argtypes = [ctypes.c_int] * 5
    lib.flash_attention_workspace.restype = ctypes.c_longlong
    lib.flash_attention_tile.argtypes = [ctypes.c_int] * 4 \
        + [ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_tile.restype = ctypes.c_int
    return lib


def instance(name, D, bq=0, bk=0):
    """What the library reports of variant ``name``'s instance at head dim
    ``D`` and tile (bq, bk) (0, 0: the default), on the card: a dict of its
    ring's ``stages``, dynamic ``smem_bytes``, ``threads`` a block,
    ``regs`` a thread and ``local_bytes`` a thread (spills), or None where
    the library has no such instance."""
    out = (ctypes.c_int * 5)()
    if _lib().flash_attention_tile(VARIANTS[name][0], D, bq, bk, out):
        return None
    return dict(zip(("stages", "smem_bytes", "threads", "regs",
                     "local_bytes"), out))


@functools.lru_cache(maxsize=1024)
def tile_of(D, dtype, *, bq=0, bk=0, kernel=None):
    """The :class:`FlashTile` a call takes: the variant ``kernel`` (default
    ``variant(D, dtype)``'s) at the tile (bq, bk), its default where both
    are 0.  Raises ``TypeError`` for a type the kernel lacks, and
    ``ValueError`` for a head dim it lacks, a variant that does not take
    ``dtype`` or is not built at ``D``, or a tile not in ``tiles(variant,
    D)`` (one value without the other too).  Cached by its arguments: the
    wrapper asks on every call."""
    name = variant(D, dtype)   # raises on a head dim or type the kernel lacks
    if kernel is not None:
        name = kernel
    if name not in VARIANTS or VARIANTS[name][1] != dtype:
        raise ValueError(f"kernel variant {name!r} does not take {dtype}")
    if D not in VARIANT_HEAD_DIMS[name]:
        raise ValueError(f"kernel variant {name!r} is not built for head "
                         f"dim {D}; it takes {VARIANT_HEAD_DIMS[name]}")
    tile = (bq, bk) if bq or bk else default_tile(name, D)
    if tile not in tiles(name, D):
        raise ValueError(f"flash_attention variant {name!r} has no tile "
                         f"(bq, bk) = {(bq, bk)} at head dim {D}; "
                         f"tiles({name!r}, {D}) = {tiles(name, D)}")
    return FlashTile(name, *tile, *_layout(name, D, *tile))


def flash_attention(q, k, v, *, causal=True, window=0, bq=0, bk=0,
                    kernel=None):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D) with ``H % Hkv == 0``, all on
    one CUDA device, all float32 or all bfloat16.  ``window > 0`` adds the
    sliding-window mask ``qpos - kpos < window``.  ``bq``, ``bk``: the
    block's tile, one of ``tiles(variant, D)``, or 0, 0 for the default.
    ``kernel`` names a variant other than ``variant(D, dtype)`` (to time one
    against another); it must take the inputs' type.  ``tile_of`` says what
    raises.  Returns (B, H, S, D)."""
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
    t = tile_of(D, q.dtype, bq=bq, bk=bk, kernel=kernel)
    name = t.variant
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
            t.bq, t.bk, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {rc} ({name} tile {(t.bq, t.bk)})")
    flash_attention.launches += 1
    flash_attention.launches_by_variant[name] += 1
    return out


def reset_counts():
    """Sets ``launches`` and every ``launches_by_variant`` count to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)


reset_counts()
