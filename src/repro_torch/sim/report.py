"""Shared reporting layer: the result dataclasses every figure reads, and
the per-kind / per-phase / per-device aggregations of a simulated timeline.

``Breakdown`` and ``Roofline`` live here so the engine and its callers speak
the same types.  ``percentile`` (deterministic linear interpolation, no
numpy dependency in the hot path) and ``latency_stats`` (the
p50/p90/p99/mean/max summary) are the population statistics of a serving
table.  The port's copy of ``repro/sim/report.py``; roofline defaults are
the H100's (``repro_torch.sim.hw``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable

from repro_torch.sim.hw import PEAK_FLOPS


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float
    useful_ratio: float
    bound: str
    step_s: float                # max of terms (+ host floor)
    roofline_fraction: float     # ideal compute_s / step_s
    detail: Dict = field(default_factory=dict)

    def to_dict(self):
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_ratio, "bound": self.bound,
            "step_s": self.step_s,
            "roofline_fraction": self.roofline_fraction,
            **self.detail,
        }


@dataclass
class Breakdown:
    """End-to-end phase breakdown (Fig 1 analogue)."""
    accelerator_s: float
    transfer_s: float
    host_s: float
    collective_s: float

    @property
    def total_s(self):
        return (self.accelerator_s + self.transfer_s + self.host_s
                + self.collective_s)

    def fractions(self):
        t = self.total_s or 1.0
        return {"accelerator": self.accelerator_s / t,
                "transfer": self.transfer_s / t,
                "host": self.host_s / t,
                "collective": self.collective_s / t}


# ---------------------------------------------------------------------------
# aggregations over timeline events


def aggregate(events: Iterable, key: str = "kind") -> Dict[str, float]:
    """Sum event durations grouped by an event attribute (kind/worker/phase
    — phase uses the event's phase tag, else the op-name prefix)."""
    out: Dict[str, float] = {}
    get = out.get
    if key == "kind":              # the hot aggregation: direct attribute
        for e in events:
            k = e.kind
            out[k] = get(k, 0.0) + e.duration
        return out
    for e in events:
        if key == "phase":
            k = getattr(e, "phase", "") or e.name.split("/")[0]
        else:
            k = getattr(e, key)
        out[k] = get(k, 0.0) + e.duration
    return out


def breakdown_from_events(events: Iterable,
                          host_floor_s: float = 0.0) -> Breakdown:
    """Fig-1 breakdown as pure aggregation of a simulated timeline."""
    kinds = aggregate(events, "kind")
    return Breakdown(
        accelerator_s=kinds.get("compute", 0.0),
        transfer_s=kinds.get("transfer", 0.0),
        host_s=kinds.get("host", 0.0) + host_floor_s,
        collective_s=kinds.get("collective", 0.0))


def per_device(events: Iterable) -> Dict[str, Dict[str, float]]:
    """Per-device kind->seconds aggregation of a simulated timeline: what
    each ``SoCTopology`` device (plus the ``host`` and ``ici`` pseudo
    lanes) spent its time on.  The heterogeneous analogue of
    ``aggregate(events, "kind")``."""
    out: Dict[str, Dict[str, float]] = {}
    for e in events:
        d = out.setdefault(e.worker, {})
        d[e.kind] = d.get(e.kind, 0.0) + e.duration
    return out


def device_breakdowns(events: Iterable) -> Dict[str, Breakdown]:
    """Fig-1 style ``Breakdown`` per device.  Host-dispatch events live on
    the ``host`` lane, collectives on ``ici``, so a compute device's row
    typically carries only its compute + transfer seconds; run-level host
    floors are a whole-run property and are not attributed here."""
    return {dev: Breakdown(accelerator_s=kinds.get("compute", 0.0),
                           transfer_s=kinds.get("transfer", 0.0),
                           host_s=kinds.get("host", 0.0),
                           collective_s=kinds.get("collective", 0.0))
            for dev, kinds in per_device(events).items()}


def roofline_from_totals(totals: Dict[str, float], *, host_s: float,
                         n_chips: int = 1, model_flops: float = 0.0,
                         peak_flops: float = PEAK_FLOPS,
                         hbm_bw: float = None, ici_bw: float = None
                         ) -> Roofline:
    """Roofline object from program aggregates (identical to the legacy
    closed form: the terms are per-device sums over the same op set)."""
    from repro_torch.sim import hw
    hbm_bw = hbm_bw or hw.HBM_BW
    ici_bw = ici_bw or hw.ICI_BW
    comp = totals["flops"] / peak_flops
    mem = (totals["bytes_in"] + totals["bytes_out"]) / hbm_bw
    # lowerings resolve the wire-vs-operand-sum choice; use wire as-is
    coll = totals.get("wire_bytes", 0.0) / ici_bw
    terms = {"compute": comp, "memory": mem, "collective": coll}
    bound = max(terms, key=terms.get)
    step = max(comp, mem, coll) + host_s
    hlo_total = totals["flops"] * n_chips
    ideal = (model_flops / n_chips) / peak_flops if n_chips else 0.0
    return Roofline(
        compute_s=comp, memory_s=mem, collective_s=coll,
        model_flops=model_flops, hlo_flops=hlo_total,
        useful_ratio=(model_flops / hlo_total) if hlo_total else 0.0,
        bound=bound, step_s=step,
        roofline_fraction=(ideal / step) if step else 0.0,
        detail={"ideal_compute_s": ideal, "host_s": host_s,
                "n_chips": n_chips})


def percentile(values: Iterable[float], q: float) -> float:
    """q-th percentile (0..100) with linear interpolation between order
    statistics — same convention as ``numpy.percentile(...,
    method="linear")``, but deterministic pure Python so serving metrics
    stay bit-reproducible across numpy versions.  Empty input -> 0.0."""
    xs = sorted(values)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return xs[0]
    rank = (len(xs) - 1) * (q / 100.0)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] + (xs[hi] - xs[lo]) * frac


def latency_stats(values: Iterable[float]) -> Dict[str, float]:
    """p50/p90/p99/mean/max summary of a latency population (seconds in,
    seconds out).  ``n`` carries the population size; an empty population
    yields all-zero stats."""
    xs = sorted(values)
    if not xs:
        return {"p50": 0.0, "p90": 0.0, "p99": 0.0, "mean": 0.0,
                "max": 0.0, "n": 0}
    return {"p50": percentile(xs, 50), "p90": percentile(xs, 90),
            "p99": percentile(xs, 99), "mean": sum(xs) / len(xs),
            "max": xs[-1], "n": len(xs)}


def latency_stats_array(values) -> Dict[str, float]:
    """``latency_stats`` vectorized for large populations: the sort runs
    in C (``numpy.sort``), the percentiles use the exact scalar
    interpolation formula of :func:`percentile`, and the mean sums the
    *sorted* values left to right — so every field is bit-identical to
    the pure-Python path on the same (NaN-free) population.  Outputs are
    Python floats (json-serializable)."""
    import numpy as np
    xs = np.sort(np.asarray(values, dtype=np.float64).ravel())
    n = int(xs.size)
    if n == 0:
        return {"p50": 0.0, "p90": 0.0, "p99": 0.0, "mean": 0.0,
                "max": 0.0, "n": 0}
    lst = xs.tolist()          # Python floats; sum(lst) matches sum(sorted)

    def pct(q: float) -> float:
        if n == 1:
            return lst[0]
        rank = (n - 1) * (q / 100.0)
        lo = int(rank)
        hi = min(lo + 1, n - 1)
        frac = rank - lo
        return lst[lo] + (lst[hi] - lst[lo]) * frac

    return {"p50": pct(50), "p90": pct(90), "p99": pct(99),
            "mean": sum(lst) / n, "max": lst[-1], "n": n}


def row(name: str, seconds: float, derived: str) -> Dict[str, object]:
    """The ``name,us_per_call,derived`` CSV convention of benchmarks/run.py."""
    return {"name": name, "us_per_call": round(seconds * 1e6, 1),
            "derived": derived}


def fractions_str(b: Breakdown) -> str:
    f = b.fractions()
    return (f"accel={f['accelerator']*100:.0f}% "
            f"transfer={f['transfer']*100:.0f}% "
            f"host={f['host']*100:.0f}% "
            f"coll={f['collective']*100:.0f}%")
