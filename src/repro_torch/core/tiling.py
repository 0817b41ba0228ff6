"""Dataflow-specialized tiling optimizer (paper §II-B), for the H100.

SMAUG's insight: don't solve the general loop-nest problem — each accelerator
implements at most a few dataflows, so enumerate only the tiling strategies
compatible with THAT dataflow and search the narrow space exhaustively,
scoring by (a) functional-unit utilization and (b) the cost of
materializing the tiles (layout contiguity).

The port's copy of ``repro/core/tiling.py``.  The hardware it scores
against is one :class:`TilingTarget`, passed at call time; the default is
the H100's (:data:`H100`); :data:`V5E` holds the reference's TPU v5e
constants, at which both choosers are the reference's, choice for choice:

  reduction quantum -> the float32 matmul's k per stage (32 floats, one
                       128-byte row of the ``tf32x3`` kernel's tiles)
  memcpy contiguity -> HBM burst contiguity (trailing-dim runs)

``choose_tiling`` gives abstract tile shapes for the simulator
(``sim/ir.py::from_graph``).  ``choose_matmul_tiling`` gives the NVDLA
matmul kernel's block shapes (``kernels/nvdla_matmul.py``): on the v5e the
reference's Pallas blocks; on the H100 one of the tiles the CUDA kernel
instantiates (:class:`MatmulKernel`), with its pipeline stages and the
split of K over blocks, scored by a modeled time over the card's SMs.
"""
from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.tensor import TensorSpec
from repro_torch.sim import hw


@dataclass(frozen=True)
class MatmulKernel:
    """One variant of the NVDLA matmul kernel, as the chooser scores it."""
    variant: str
    # (bm, bn, bk, stages, shared-memory bytes) of each tile it instantiates
    tiles: Tuple[Tuple[int, int, int, int, int], ...]
    flops: float                 # its products' peak rate on the card, FLOP/s
    passes: int = 1              # products a multiply-add takes (tf32x3: 3)
    parts: int = 1               # copies of each operand a stage loads
    ring: bool = False           # fed by a TMA ring of ``stages`` loads
    blocks_per_sm: int = 1       # its blocks an SM holds at once
    persistent: bool = False     # a grid of one block an SM walking the tiles
    split_depth: int = 0         # least k one split of K takes; 0: no split
    split_align: int = 1         # a split's k range is a multiple of this


@dataclass(frozen=True)
class TilingTarget:
    """The hardware a tiling is scored against.  The matmul chooser's two
    fields default to the TPU v5e's."""
    # elements of the reduction dim one step of the dataflow consumes
    reduce_quantum: int
    hbm_bw: float                    # bytes/s
    copy_latency_s: float            # fixed cost of one contiguous copy
    # bytes one matmul block's tiles may take (the v5e: half of VMEM)
    matmul_budget: int = 128 * 1024 * 1024 // 2
    # cores walking the matmul's grid at once: one takes the reference's
    # chooser, more the H100's (waves of tiles over the SMs)
    sm_count: int = 1


# The reference's TPU v5e (src/repro/core/tiling.py:27-32): VMEM_BYTES // 2
# a block, the 128 x 128 MXU (its side is the quantum of every dim the
# reference's chooser scores), HBM at 819e9 B/s, 1 us a transaction; one
# core walks the grid in order
V5E = TilingTarget(reduce_quantum=128, hbm_bw=819e9, copy_latency_s=1e-6)
# the reference's candidate blocks (src/repro/core/tiling.py:174-176)
V5E_BLOCKS = tuple((bm, bn, bk) for bm in (128, 256, 512)
                   for bn in (128, 256, 512)
                   for bk in (128, 256, 512, 1024, 2048))

SMALL_M = 16   # at most this many rows: the decoding-row variants
_RING_ALIGN = 1024   # a TMA ring's slack for its 1024-byte-aligned boxes


def _ring(stages, stage_bytes, out_bytes=0):
    """Shared-memory bytes of a TMA ring kernel (csrc/nvdla_matmul.cu
    ``wg::Tile::SMEM``, ``tf::Tile::SMEM``): the alignment slack, the
    stages, the output staging and a full and an empty mbarrier a stage."""
    return _RING_ALIGN + stages * stage_bytes + out_bytes + 16 * stages


def _tf32x3_tile(bm, bn, stages):
    # a stage: hi and lo of a's (bm x 32) and b^T's (bn x 32) float32 boxes
    return (bm, bn, 32, stages, _ring(stages, 2 * (bm + bn) * 32 * 4))


def _wgmma_tile(bn, stages):
    # a stage: a's (128 x 64) and b's (64 x bn) bf16 boxes; the output
    # staged as bf16 in shared memory for its TMA store
    return (128, bn, 64, stages, _ring(stages, (128 + bn) * 64 * 2,
                                       128 * bn * 2))


# The H100 SXM: 227 KB of dynamic shared memory a block (232,448 bytes;
# CUDA C++ Programming Guide, compute capability 9.0), wgmma's 64 rows and
# N a multiple of 8 (PTX ISA, wgmma.mma_async), K a stage one 128-byte TMA
# row (32 floats, 64 bf16: the 128-byte swizzle's row), 132 SMs (Hopper
# white paper).  The rates are the data sheet's (sim/hw.py).  Each stage
# count is the most that fits, at most 4.  FEED_BW, SM_FEED_BW and
# LOAD_LATENCY_S rank tiles rather than predict times: they are the round
# values at which the chooser's tf32x3 picks over chip_smoke.py phase 57's
# sweep (every tile at every float32 shape of more than 16 rows it times)
# came within 1.2% of the fastest tile in sum and were nowhere slower than
# the 128-row tiles the kernel fixed before, on an H100 80GB HBM3 at
# 700.00 W; 2-stage rings ran 12-17% slower than 3-stage ones at the
# model grid's shapes, which the latency term charges.
H100_MATMUL_KERNELS = (
    MatmulKernel("tf32x3", (
        _tf32x3_tile(64, 64, 4), _tf32x3_tile(64, 112, 4),
        _tf32x3_tile(64, 128, 4), _tf32x3_tile(64, 256, 2),
        _tf32x3_tile(128, 64, 4), _tf32x3_tile(128, 112, 3),
        _tf32x3_tile(128, 128, 3), _tf32x3_tile(128, 256, 2)),
        hw.PEAK_FLOPS_TF32, passes=3, parts=2, ring=True, persistent=True,
        split_depth=128, split_align=32),
    MatmulKernel("wgmma", (
        _wgmma_tile(64, 4), _wgmma_tile(128, 4), _wgmma_tile(256, 3)),
        hw.PEAK_FLOPS_BF16, ring=True, persistent=True),
    # 256 threads, 4 columns each, 8 k rows in flight in registers; K
    # split for about 4 blocks an SM, each at least 64 k rows deep
    MatmulKernel("stream", ((16, 1024, 8, 1, 0),), hw.PEAK_FLOPS,
                 blocks_per_sm=4, split_depth=64, split_align=8),
    # one shared stage (rows padded by 8 bf16) and the next in registers;
    # K split for about 2 blocks an SM, each at least 256 k deep
    MatmulKernel("mma_sync", (
        (16, 128, 32, 1, 16 * 40 * 2 + 32 * 136 * 2),
        (128, 128, 32, 1, 128 * 40 * 2 + 32 * 136 * 2)), hw.PEAK_FLOPS_BF16,
        blocks_per_sm=2, split_depth=256, split_align=32),
    # a's tile transposed with rows padded by 4 floats, b's tile
    MatmulKernel("fma", (
        (16, 128, 16, 1, 16 * 20 * 4 + 16 * 128 * 4),
        (128, 128, 8, 1, 8 * 132 * 4 + 8 * 128 * 4)), hw.PEAK_FLOPS,
        blocks_per_sm=2, split_depth=256, split_align=32),
)

# reduce_quantum: the float32 matmul's k per stage, csrc/nvdla_matmul.cu
# (tf32x3's 32; the FMA kernel's 8 and 16 divide it); copy_latency_s: one
# small device copy (64 KiB, one default tile), back to back: 1.900 us,
# chip_smoke.py phase 22 on an H100 80GB HBM3 at 700.00 W, which the matmul
# chooser also charges a split-K sum's launch
H100 = TilingTarget(reduce_quantum=32, hbm_bw=hw.HBM_BW,
                    copy_latency_s=1.9e-6, matmul_budget=232448,
                    sm_count=hw.N_SMS)
FEED_BW = 10e12          # operand bytes/s all SMs load at once
SM_FEED_BW = 80e9        # operand bytes/s one SM loads at most
LOAD_LATENCY_S = 1e-6    # a ring stage's load, issue to arrival


@dataclass(frozen=True)
class TilingChoice:
    """One evaluated tiling of a tensor."""
    strategy: str                    # e.g. "DimC", "DimHW", "DimNH"
    tile_shape: tuple
    n_tiles: int
    n_memcpys: int
    contiguous_run: int              # elements per memcpy
    utilization: float               # fraction of compute-dim quantum used
    host_cost_s: float               # modeled tile-materialization time

    def __str__(self):
        return (f"{self.strategy}: tile={self.tile_shape} n={self.n_tiles} "
                f"memcpys={self.n_memcpys} run={self.contiguous_run} "
                f"util={self.utilization:.2f} host={self.host_cost_s*1e6:.1f}us")


def _host_cost(n_memcpys: int, total_bytes: int,
               target: TilingTarget) -> float:
    """Tile-materialization cost: bandwidth term + per-memcpy overhead.
    Reproduces the Fig 6 effect: many tiny memcpys lose to few large ones."""
    return total_bytes / target.hbm_bw + n_memcpys * target.copy_latency_s


def enumerate_tilings(spec: TensorSpec, max_tile_elems: int,
                      reduce_dim: Optional[str] = None,
                      target: TilingTarget = H100) -> List[TilingChoice]:
    """All dataflow-compatible tilings of ``spec`` under the tile budget.

    ``reduce_dim``: the dimension the dataflow reduces over (NVDLA: channels;
    matmul: the contraction dim).  Tiles keep it a multiple of
    ``target.reduce_quantum`` where possible (functional-unit utilization).
    """
    quantum = target.reduce_quantum
    dims = spec.dims
    choices: List[TilingChoice] = []
    # all subsets of dims to tile (strategy DimXY... = dims being cut)
    for r in range(1, len(dims) + 1):
        for cut in itertools.combinations(range(len(dims)), r):
            strategy = "Dim" + "".join(dims[i] for i in cut)
            tile = _best_tile_for_cut(spec, cut, max_tile_elems,
                                      reduce_dim, quantum)
            if tile is None:
                continue
            n_elems_tile = math.prod(tile)
            if n_elems_tile > max_tile_elems:
                continue
            n_tiles = 1
            for full, t in zip(spec.shape, tile):
                n_tiles *= math.ceil(full / t)
            n_memcpys = spec.n_memcpys(tile)
            run = spec.contiguous_run(tile)
            util = 1.0
            if reduce_dim and reduce_dim in dims:
                rd = tile[dims.index(reduce_dim)]
                util = min(1.0, rd / quantum) if rd < quantum \
                    else (rd // quantum) * quantum / rd
            choices.append(TilingChoice(
                strategy=strategy, tile_shape=tuple(tile), n_tiles=n_tiles,
                n_memcpys=n_memcpys, contiguous_run=run, utilization=util,
                host_cost_s=_host_cost(n_memcpys, spec.nbytes, target)))
    return choices


def _best_tile_for_cut(spec, cut, max_tile_elems, reduce_dim, quantum):
    """Largest tile that fits when cutting exactly the dims in ``cut``."""
    tile = list(spec.shape)
    fixed = 1
    for i, d in enumerate(spec.shape):
        if i not in cut:
            fixed *= d
    if fixed > max_tile_elems:
        return None
    room = max_tile_elems // fixed
    # distribute ``room`` across cut dims: reduce dim first (functional-unit
    # quantum), then innermost-first to preserve trailing contiguity (the
    # paper's DimHW-over-DimCH effect)
    for i in sorted(cut, key=lambda i: (-(spec.dims[i] == (reduce_dim or "")),
                                        -i)):
        d = spec.shape[i]
        t = min(d, room)
        if reduce_dim and spec.dims[i] == reduce_dim and t < d:
            t = max(quantum * (t // quantum), min(d, quantum))
        t = max(1, t)
        tile[i] = t
        room = max(1, room // max(t, 1))
    if math.prod(tile) > max_tile_elems:
        # shrink the largest cut dim
        for i in sorted(cut, key=lambda i: -tile[i]):
            while math.prod(tile) > max_tile_elems and tile[i] > 1:
                tile[i] = max(1, tile[i] // 2)
    return tuple(tile)


def choose_tiling(spec: TensorSpec, max_tile_elems: int,
                  reduce_dim: Optional[str] = None,
                  w_util: float = 1.0, w_host: float = 1.0,
                  target: TilingTarget = H100) -> TilingChoice:
    """The optimizer: exhaustively score the narrow strategy space.

    Score = utilization - normalized host cost (both effects the paper
    demonstrates; weights let case studies ablate them)."""
    cands = enumerate_tilings(spec, max_tile_elems, reduce_dim, target)
    if not cands:
        raise ValueError(f"no feasible tiling for {spec} within "
                         f"{max_tile_elems} elems")
    worst_host = max(c.host_cost_s for c in cands) or 1.0

    def score(c: TilingChoice) -> float:
        return w_util * c.utilization - w_host * (c.host_cost_s / worst_host)

    return max(cands, key=score)


# ---------------------------------------------------------------------------
# matmul tiling -> the NVDLA matmul kernel's block shapes


@dataclass(frozen=True)
class MatmulTiling:
    """A matmul's blocks: ``bm`` x ``bn`` output tiles, ``bk`` of K a step.
    ``vmem_bytes`` is the working set: on the v5e one grid step's VMEM (the
    reference's), on the H100 the block's shared-memory bytes.  ``stages``
    is the depth of the kernel's load pipeline, ``splits`` the blocks K is
    split over (their float32 partials summed by a second pass) and
    ``variant`` the kernel variant the tiles are for; the v5e leaves them
    at 1, 1 and ``""``."""
    bm: int
    bn: int
    bk: int
    vmem_bytes: int
    util_m: float
    util_n: float
    util_k: float
    stages: int = 1
    splits: int = 1
    variant: str = ""


def hopper_variant(M: int, N: int, K: int, dtype_bytes: int) -> str:
    """The matmul kernel's variant for an (M, K) @ (K, N) product of
    ``dtype_bytes`` elements: float32 (4) ``"tf32x3"`` for M > 16 rows and
    ``"stream"`` otherwise; bf16 (2) ``"wgmma"`` for M > 16 with K and N
    multiples of 8 (row strides TMA can describe), ``"mma_sync"``
    otherwise."""
    if dtype_bytes == 4:
        return "tf32x3" if M > SMALL_M else "stream"
    if dtype_bytes == 2:
        return "wgmma" if M > SMALL_M and K % 8 == 0 and N % 8 == 0 \
            else "mma_sync"
    raise ValueError(f"no matmul variant for {dtype_bytes}-byte elements")


def matmul_kernel(variant: str) -> MatmulKernel:
    """The H100's :class:`MatmulKernel` of ``variant``."""
    for k in H100_MATMUL_KERNELS:
        if k.variant == variant:
            return k
    raise ValueError(f"no matmul variant {variant!r}")


def split_count(M: int, N: int, K: int, tile, kern: MatmulKernel,
                sm_count: int) -> int:
    """The blocks K is split over at ``tile``: where the output tiles fill
    less than one wave of ``sm_count`` SMs, enough splits for the SMs'
    block slots (a persistent kernel: at most one wave; another, about
    ``blocks_per_sm`` an SM), each at least ``split_depth`` k deep, a split
    a multiple of ``split_align``.  The count returned is the one those
    aligned splits give (every split non-empty)."""
    bm, bn = tile[:2]
    tiles = math.ceil(M / bm) * math.ceil(N / bn)
    if not kern.split_depth or tiles >= sm_count:
        return 1
    slots = sm_count * kern.blocks_per_sm
    want = slots // tiles if kern.persistent else math.ceil(slots / tiles)
    return aligned_splits(K, min(want, K // kern.split_depth),
                          kern.split_align)


def aligned_splits(K: int, splits: int, align: int) -> int:
    """The non-empty splits of K when each takes ceil(K / splits) rounded up
    to ``align`` (at least 1)."""
    if splits <= 1:
        return 1
    chunk = math.ceil(math.ceil(K / splits) / align) * align
    return math.ceil(K / chunk)


def _modeled_s(M, N, K, tile, splits, kern, dtype_bytes, target):
    """Seconds the card takes at ``tile`` and ``splits``, modeled: waves of
    (tile, split) blocks over the SMs' slots, each its k steps at the
    slowest of the products at the variant's peak, the operands' feed (its
    share of ``FEED_BW``) and, for a TMA ring, a load's latency over the
    stages in flight, plus a ring's fill; a split adds the sum's launch and
    its float32 partials' round trip through HBM."""
    bm, bn, bk, stages = tile[:4]
    slots = target.sm_count * kern.blocks_per_sm
    items = math.ceil(M / bm) * math.ceil(N / bn) * splits
    steps = math.ceil(math.ceil(K / splits) / bk)
    feed = min(SM_FEED_BW, FEED_BW / min(items, slots))
    step = max(kern.passes * 2 * bm * bn * bk * slots / kern.flops,
               kern.parts * (bm + bn) * bk * dtype_bytes / feed)
    fill = 0.0
    if kern.ring:   # a stage's load waits for the one stages - 1 back
        step = max(step, (LOAD_LATENCY_S + step) / max(1, stages - 1))
        fill = LOAD_LATENCY_S
    t = math.ceil(items / slots) * (steps * step + fill)
    if splits > 1:
        t += target.copy_latency_s + 8 * splits * M * N / target.hbm_bw
    return t


def _util(n, t):
    """The share of ceil(n / t) tiles of t that holds n."""
    return n / (math.ceil(n / t) * t)


@functools.lru_cache(maxsize=4096)
def _choose_hopper(M, N, K, dtype_bytes, budget, target, variant, block):
    """``choose_matmul_tiling`` on a target of many SMs."""
    kern = matmul_kernel(variant)
    best = None
    for tile in kern.tiles:
        bm, bn, bk, stages, smem = tile
        if block and (bm, bn, bk) != block or smem > budget:
            continue
        splits = split_count(M, N, K, tile, kern, target.sm_count)
        t = _modeled_s(M, N, K, tile, splits, kern, dtype_bytes, target)
        if best is None or t < best[0]:
            best = (t, MatmulTiling(
                bm=bm, bn=bn, bk=bk, vmem_bytes=smem, util_m=_util(M, bm),
                util_n=_util(N, bn), util_k=_util(K, bk), stages=stages,
                splits=splits, variant=variant))
    if best is None:
        raise ValueError(f"no {variant} tile {block or ''} fits "
                         f"{budget} bytes")
    return best[1]


@functools.lru_cache(maxsize=4096)
def _choose_single_core(M, N, K, dtype_bytes, budget, target):
    """The reference's chooser (``repro/core/tiling.py:163``), copied: the
    largest K block, then the largest tile, whose working set fits."""
    best = None
    for bm, bn, bk in V5E_BLOCKS:
        tbm, tbn, tbk = (min(bm, M), min(bn, N), min(bk, K))
        ws = (tbm * tbk + tbk * tbn) * dtype_bytes + tbm * tbn * 4
        if ws > budget:
            continue
        # prefer larger K blocks (fewer partial-sum round trips),
        # then larger tiles overall
        key = (tbk, tbm * tbn, -(tbm + tbn))
        if best is None or key > best[0]:
            q = target.reduce_quantum
            best = (key, MatmulTiling(
                bm=tbm, bn=tbn, bk=tbk, vmem_bytes=ws,
                util_m=_mxu_util(tbm, q), util_n=_mxu_util(tbn, q),
                util_k=_mxu_util(tbk, q)))
    if best is None:
        return MatmulTiling(min(128, M), min(128, N), min(128, K),
                            0, 1.0, 1.0, 1.0)
    return best[1]


def choose_matmul_tiling(M: int, N: int, K: int, dtype_bytes: int = 2,
                         budget: Optional[int] = None,
                         target: TilingTarget = H100,
                         variant: Optional[str] = None,
                         block: Optional[Tuple[int, int, int]] = None
                         ) -> MatmulTiling:
    """Block shapes of the NVDLA matmul kernel for an (M, K) @ (K, N)
    product of ``dtype_bytes`` elements, the working set within ``budget``
    bytes (default the target's ``matmul_budget``).  Cached by its
    arguments: the kernel's wrapper asks on every product.

    On a one-core target (``sm_count`` 1: :data:`V5E`) it is the
    reference's chooser, field for field: blocks of its candidates clipped
    to the product, working set bm bk + bk bn in ``dtype_bytes`` plus the
    float32 bm bn accumulator, the largest K block first.

    On the H100 it enumerates the tiles the kernel instantiates for
    ``variant`` (default ``hopper_variant``'s), or only ``block`` = (bm,
    bn, bk) where given, keeps those within the budget (every stage, tf32x3's
    hi and lo parts, the ring's barriers and slack), splits K where the
    output tiles fill less than a wave (``split_count``), and takes the
    tile of least modeled time (``_modeled_s``: waves of tiles over the
    SMs); ties keep the first in ``tiles``.  Raises ``ValueError`` when no
    tile fits."""
    budget = target.matmul_budget if budget is None else budget
    if target.sm_count == 1:
        return _choose_single_core(M, N, K, dtype_bytes, budget, target)
    variant = variant or hopper_variant(M, N, K, dtype_bytes)
    return _choose_hopper(M, N, K, dtype_bytes, budget, target, variant,
                          tuple(block) if block else None)


def _mxu_util(t: int, quantum: int) -> float:
    if t >= quantum:
        return (t // quantum) * quantum / t
    return t / quantum
