"""Execution timeline (paper Fig 14 / Fig 19 analogue).

Collects (worker, name, start, duration, kind) events from the scheduler /
simulator, renders an ASCII utilization view and exports Chrome trace JSON.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Event:
    worker: str
    name: str
    start: float
    duration: float
    kind: str = "compute"   # compute | transfer | host | collective | idle
    phase: str = ""         # reporting group (falls back to name prefix)

    @property
    def end(self) -> float:
        return self.start + self.duration


@dataclass
class Timeline:
    events: List[Event] = field(default_factory=list)
    # set by the engine once a run's events are final (the makespan fold
    # is O(events) and every post-run metric asks for it); ``add``
    # invalidates it, so incrementally-built timelines stay correct
    _mk_cache: Optional[float] = field(default=None, repr=False,
                                       compare=False)

    def add(self, worker, name, start, duration, kind="compute", phase=""):
        self._mk_cache = None
        self.events.append(Event(worker, name, start, duration, kind, phase))

    @property
    def makespan(self) -> float:
        mk = self._mk_cache
        if mk is not None:
            return mk
        return max((e.end for e in self.events), default=0.0)

    def utilization(self, worker: Optional[str] = None) -> float:
        evs = [e for e in self.events
               if (worker is None or e.worker == worker)
               and e.kind != "idle"]
        busy = sum(e.duration for e in evs)
        workers = {e.worker for e in self.events} if worker is None \
            else {worker}
        total = self.makespan * max(len(workers), 1)
        return busy / total if total else 0.0

    def per_kind(self) -> Dict[str, float]:
        from repro_torch.sim.report import aggregate  # single aggregation home
        return aggregate(self.events, "kind")

    def per_phase(self) -> Dict[str, float]:
        from repro_torch.sim.report import aggregate
        return aggregate(self.events, "phase")

    def to_chrome_trace(self) -> str:
        evs = [{"name": e.name, "ph": "X", "ts": e.start * 1e6,
                "dur": e.duration * 1e6, "pid": 0, "tid": e.worker,
                "args": {"kind": e.kind}} for e in self.events]
        return json.dumps({"traceEvents": evs})

    def ascii(self, width: int = 78) -> str:
        """Per-worker busy/idle bar chart."""
        span = self.makespan or 1.0
        workers = sorted({e.worker for e in self.events})
        sym = {"compute": "#", "transfer": "~", "host": "h",
               "collective": "c", "idle": "."}
        lines = []
        for w in workers:
            row = ["."] * width
            for e in self.events:
                if e.worker != w:
                    continue
                a = int(e.start / span * width)
                b = max(a + 1, int(e.end / span * width))
                for i in range(a, min(b, width)):
                    row[i] = sym.get(e.kind, "#")
            lines.append(f"{w:>12s} |{''.join(row)}|")
        lines.append(f"{'':>12s}  0{'':{width-10}}{span*1e3:.2f} ms")
        return "\n".join(lines)
