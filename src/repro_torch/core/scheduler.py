"""Runtime scheduler (paper §II-C): tile-level parallelism over an
accelerator worker pool, with reduction affinity.

``simulate(...)`` is the discrete-event simulation of the pool given tile
durations (the multi-accelerator case study, Fig 12/14): tiles whose partial
results must be reduced in place are pinned to one queue (affinity key),
reproducing the under-utilization SMAUG observed on VGG16 layers 8/9.

The port's copy of ``repro/core/scheduler.py``'s ``TileTask`` and
``simulate``; the reference's host-side ``ThreadPool`` is not copied.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.timeline import Timeline


@dataclass(frozen=True)
class TileTask:
    name: str
    duration: float                 # seconds (from the simulator/cost model)
    affinity: Optional[str] = None  # reduction-affinity key: same key ->
                                    # same worker queue (in-place partials)
    transfer: float = 0.0           # data-in time occupying the memory port
    deps: tuple = ()                # names that must complete first


def simulate(tasks: Sequence[TileTask], n_workers: int,
             shared_bw_penalty: float = 0.0) -> Timeline:
    """Discrete-event simulation of the worker pool.

    Thin wrapper over the engine (``repro_torch.sim.engine``): tasks lower
    to ``CostedOp``s with explicit durations and the engine schedules them
    (LPT, affinity queues, HBM-port contention).

    ``shared_bw_penalty`` is a per-extra-transfer fractional slowdown,
    translated into an equivalent HBM port count (worst-case slowdown
    ``1 + p*(n-1)`` == ``n_workers / ports``).
    """
    from repro_torch.sim import engine, ir
    prog = ir.from_tasks(tasks, name="tiles")
    if shared_bw_penalty > 0.0 and n_workers > 1:
        # fractional ports keep the translation exact for every pool size
        # (integer rounding would erase the penalty for small n)
        ports = n_workers / (1.0 + shared_bw_penalty * (n_workers - 1))
    else:
        ports = 0  # one port per worker: no contention
    cfg = engine.EngineConfig(n_workers=n_workers, interface="hbm",
                              hbm_ports=ports)
    return engine.run(prog, cfg).timeline
