"""Runtime scheduler (paper §II-C): accelerator worker pool + per-worker
command queues, tile-level parallelism, and reduction affinity.

Two modes:
  * ``simulate(...)``   — discrete-event simulation of the pool given tile
    durations (the multi-accelerator case study, Fig 12/14): tiles whose
    partial results must be reduced in place are pinned to one queue
    (affinity key), reproducing the under-utilization SMAUG observed on
    VGG16 layers 8/9.
  * ``ThreadPool``      — a real host-side worker pool for data preparation
    (the multithreading case study, Fig 16): tasks run to completion,
    workers wait on a queue until work arrives.

The port's copy of ``repro/core/scheduler.py``.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

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


# ---------------------------------------------------------------------------
# real host-side worker pool (data preparation / finalization)


class ThreadPool:
    """Run-to-completion task pool with quiesced (queue-waiting) workers.

    The paper implements this inside gem5 because syscall-emulation has no
    kernel scheduler; here it is the host-side data-preparation pool.  NumPy
    memcpys release the GIL, so tiling/untiling tasks scale with workers.
    """

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self._q: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        for i in range(n_workers):
            th = threading.Thread(target=self._worker, name=f"pool{i}",
                                  daemon=True)
            th.start()
            self._threads.append(th)

    def _worker(self):
        while not self._stop.is_set():
            try:
                fn, args, ev, out = self._q.get(timeout=0.1)
            except queue.Empty:
                continue  # quiesced wait
            try:
                out.append(fn(*args))
            except Exception as e:  # noqa: BLE001 — re-raised by map()
                out.append(e)
            ev.set()
            self._q.task_done()

    def map(self, fn: Callable, items: Sequence) -> List:
        """Dispatch fn over items; blocks until all complete (join)."""
        slots = []
        for it in items:
            ev = threading.Event()
            out: List = []
            self._q.put((fn, (it,), ev, out))
            slots.append((ev, out))
        results = []
        for ev, out in slots:
            ev.wait()
            r = out[0]
            if isinstance(r, Exception):
                raise r
            results.append(r)
        return results

    def shutdown(self):
        self._stop.set()
        for th in self._threads:
            th.join(timeout=1.0)
