"""The calibration fit and the measured-sample cost backend.

The port's own copy of what calibration needs from ``repro/sim/backends.py``:
``mape``, ``fit_linear_cost``, ``TableBackend`` and ``table_from_samples``.
The rest of the cost-backend layer (roofline and systolic backends, the
registry) is not copied yet.  numpy only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class TableBackend:
    """Measured-sample lookup: ``(op_kind, flops, seconds)`` tuples.

    Pricing is log-log interpolation over the samples of the op's
    ``op_kind`` (falling back to the ``""`` kind, then to all samples
    pooled), clamped at the measured range's ends.  An op whose flops
    exactly matches a sample returns the measured seconds exactly."""

    samples: Tuple[Tuple[str, float, float], ...]
    name: str = "table"

    def __post_init__(self):
        if not self.samples:
            raise ValueError("TableBackend needs at least one sample")

    @cached_property
    def _tables(self) -> Dict[str, tuple]:
        by_kind: Dict[str, list] = {}
        for kind, flops, secs in self.samples:
            by_kind.setdefault(kind, []).append((float(flops),
                                                 float(secs)))
            by_kind.setdefault(None, []).append((float(flops),
                                                 float(secs)))
        tables: Dict[str, tuple] = {}
        for kind, pts in by_kind.items():
            pts.sort()
            xs = np.log(np.array([p[0] for p in pts]))
            ys = np.log(np.array([p[1] for p in pts]))
            tables[kind] = (xs, ys, dict(pts))
        return tables

    def _lookup(self, kind: str, flops: float) -> float:
        tabs = self._tables
        tab = tabs.get(kind)
        if tab is None:
            tab = tabs.get("") if "" in tabs else tabs[None]
        xs, ys, exact = tab
        hit = exact.get(flops)
        if hit is not None:
            return hit
        return float(np.exp(np.interp(math.log(flops), xs, ys)))

    def op_time(self, op, eff=None) -> float:
        """Seconds for ``op``: any object with ``duration_s``, ``flops`` and
        ``op_kind``.  A set ``duration_s`` wins; no flops cost nothing."""
        if op.duration_s is not None:
            return op.duration_s
        if op.flops <= 0.0:
            return 0.0
        return self._lookup(op.op_kind, op.flops)


def mape(pred, measured) -> float:
    """Mean absolute percentage error of ``pred`` against ``measured``."""
    p = np.asarray(pred, dtype=np.float64)
    m = np.asarray(measured, dtype=np.float64)
    return float(np.mean(np.abs(p - m) / m))


def fit_linear_cost(flops, bytes_, measured) -> Dict[str, float]:
    """Fit ``t ~= flops/peak_eff + bytes/bw_eff + overhead_s`` by least
    squares over measured samples.

    The design columns are ``[flops, bytes, 1]``; a column whose best
    coefficient comes out negative is dropped and the rest refit (a
    one-pass non-negativity projection).

    Returns ``peak_flops_eff`` / ``bw_eff`` (inf when the term vanished),
    ``overhead_s``, the per-sample predictions and the fit MAPE."""
    f = np.asarray(flops, dtype=np.float64)
    b = np.asarray(bytes_, dtype=np.float64)
    t = np.asarray(measured, dtype=np.float64)
    cols = [f, b, np.ones_like(t)]
    active = [0, 1, 2]
    coef = np.zeros(3)
    for _ in range(3):
        X = np.stack([cols[i] for i in active], axis=1)
        sol, *_ = np.linalg.lstsq(X, t, rcond=None)
        coef[:] = 0.0
        for i, c in zip(active, sol):
            coef[i] = c
        neg = [i for i, c in zip(active, sol) if c < 0.0]
        if not neg:
            break
        worst = min(neg, key=lambda i: coef[i])
        coef[worst] = 0.0
        active = [i for i in active if i != worst]
        if not active:
            break
    pred = coef[0] * f + coef[1] * b + coef[2]
    return {
        "peak_flops_eff": (1.0 / coef[0]) if coef[0] > 0.0 else math.inf,
        "bw_eff": (1.0 / coef[1]) if coef[1] > 0.0 else math.inf,
        "overhead_s": float(coef[2]),
        "pred": pred,
        "mape": mape(pred, t),
    }


def table_from_samples(records) -> TableBackend:
    """Build a :class:`TableBackend` from calibration records — dicts
    with ``kind`` (op_kind), ``flops`` and ``measured_s`` keys."""
    return TableBackend(samples=tuple(
        (r["kind"], float(r["flops"]), float(r["measured_s"]))
        for r in records))
