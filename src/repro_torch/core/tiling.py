"""Dataflow-specialized tiling optimizer (paper §II-B), for the H100.

SMAUG's insight: don't solve the general loop-nest problem — each accelerator
implements at most a few dataflows, so enumerate only the tiling strategies
compatible with THAT dataflow and search the narrow space exhaustively,
scoring by (a) functional-unit utilization and (b) the cost of
materializing the tiles (layout contiguity).

The port's copy of ``repro/core/tiling.py``'s chooser.  The hardware it
scores against is one :class:`TilingTarget`, passed at call time; the
default is the H100's (:data:`H100`):

  reduction quantum -> the float32 matmul's k per stage (32 floats, one
                       128-byte row of the ``tf32x3`` kernel's tiles)
  memcpy contiguity -> HBM burst contiguity (trailing-dim runs)

Outputs abstract tile shapes for the simulator (``sim/ir.py::from_graph``).
The reference's Pallas block chooser (``choose_matmul_tiling``) is not
copied: the port's kernels fix their tiles per variant.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.tensor import TensorSpec
from repro_torch.sim import hw


@dataclass(frozen=True)
class TilingTarget:
    """The hardware a tiling is scored against."""
    # elements of the reduction dim one step of the dataflow consumes
    reduce_quantum: int
    hbm_bw: float                    # bytes/s
    copy_latency_s: float            # fixed cost of one contiguous copy


# reduce_quantum: the float32 matmul's k per stage, csrc/nvdla_matmul.cu
# H_BK (tf32x3) and BK (FMA kernel); copy_latency_s: one small device copy
# (64 KiB, one default tile), back to back: 1.900 us, chip_smoke.py phase
# 22 on an H100 80GB HBM3 at 700.00 W
H100 = TilingTarget(reduce_quantum=32, hbm_bw=hw.HBM_BW,
                    copy_latency_s=1.9e-6)


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
