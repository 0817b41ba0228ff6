"""Pluggable per-op compute-cost backends and the calibration fit.

The engine's native per-op compute charge is the roofline scalar
``flops / peak_flops`` (an explicit ``duration_s`` always wins).  This
module turns that charge into a strategy object behind the
:class:`CostBackend` protocol, so the detail level is an
``EngineConfig``/``Device`` knob:

* :class:`RooflineBackend` — the engine's own math.
  ``EngineConfig.cost_backend=None`` (the default) *means* roofline and
  keeps every engine hot path on its inline expression, so the default is
  bit-identical to an explicit roofline backend by construction.
* :class:`SystolicBackend` — SCALE-Sim-style PE-array timing: spatial
  utilization of a ``rows x cols`` array under the op's compute-tile
  shape, pipeline fill/drain exposed when SRAM double-buffering is off,
  and im2col staging traffic for convolution tiles.
* :class:`TableBackend` — interpolated lookup over measured samples;
  ``repro_torch.kernels.calibrate`` builds one from the port's CUDA
  kernels timed on the card.

Backends price *compute* only.  Transfer, host and collective terms stay
with the engine's interface models — a backend sees the resolved
effective config (``peak_flops``, ``hbm_bw``, ...) of the device the op
lands on and returns seconds.  Every backend is a frozen dataclass, so
configs carrying one stay hashable (the engine's ``lru_cache`` resolution
layers require this).

The calibration helpers at the bottom (:func:`fit_linear_cost`,
:func:`mape`, :func:`table_from_samples`) are shared by
``repro_torch.kernels.calibrate`` and the tests.  The port's own copy of
``repro/sim/backends.py``; numpy only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Dict, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class CostBackend(Protocol):
    """Prices one op's compute time on one resolved device config.

    ``op`` is a :class:`repro_torch.sim.ir.CostedOp` (``flops``, optional
    ``duration_s`` override, optional ``tile``/``op_kind`` metadata);
    ``eff`` is the effective ``EngineConfig`` of the device the op runs
    on.  Implementations must honor ``op.duration_s`` when set — that is
    the engine's contract with the TileTask lowering."""

    name: str

    def op_time(self, op, eff) -> float:
        ...


@dataclass(frozen=True)
class RooflineBackend:
    """The engine's native charge: ``flops / peak_flops``.

    Exists so a backend can be *named*; the engine treats
    ``cost_backend=None`` and an instance of this class identically (the
    ``op_time`` body below is textually the engine's inline expression,
    so even the explicit instance is bit-identical)."""

    name: str = "roofline"

    def op_time(self, op, eff) -> float:
        return (op.duration_s if op.duration_s is not None
                else op.flops / eff.peak_flops)


@dataclass(frozen=True)
class SystolicBackend:
    """SCALE-Sim-style output-stationary PE-array model.

    The array's defaults (128 x 128 PEs) are the JAX package's model of
    SMAUG's simulated accelerator, not the H100's tensor cores.

    An op whose ``tile`` metadata names a ``(M, N, K)`` compute tile is
    priced at ``flops / (peak_flops * utilization)``:

    * **spatial** — the ``M x N`` output tile folds onto the
      ``rows x cols`` array in ``ceil(M/rows) * ceil(N/cols)`` passes;
      partially filled edge folds idle PEs, so utilization is
      ``(M / (ceil(M/rows)*rows)) * (N / (ceil(N/cols)*cols))`` — exactly
      1.0 when both dims are array-aligned.
    * **temporal** — with ``double_buffered`` SRAM (the default) operand
      staging overlaps the previous fold and only the steady-state ``K``
      beats count; without it each fold exposes the ``rows + cols - 2``
      pipeline fill/drain beats: ``K / (K + rows + cols - 2)``.

    Convolution tiles additionally pay im2col staging: the lowered
    ``M x K`` patch matrix re-reads each input element up to ``k*k``
    times, so traffic beyond the op's original operand bytes is charged
    at the device's HBM rate (``im2col=False`` switches that off, for
    hardware with native convolution dataflow).

    Ops without tile metadata fall back to full utilization — the
    roofline charge."""

    rows: int = 128
    cols: int = 128
    double_buffered: bool = True
    im2col: bool = True
    name: str = "systolic"

    def utilization(self, tile: Sequence[int]) -> float:
        """PE-array utilization in (0, 1] for a ``(M, N, K)`` tile."""
        if not tile or len(tile) < 2:
            return 1.0
        m, n = float(tile[0]), float(tile[1])
        if m <= 0.0 or n <= 0.0:
            return 1.0
        spatial = (m / (math.ceil(m / self.rows) * self.rows)) \
            * (n / (math.ceil(n / self.cols) * self.cols))
        if self.double_buffered:
            return spatial
        k = float(tile[2]) if len(tile) > 2 and tile[2] > 0 else 1.0
        return spatial * (k / (k + self.rows + self.cols - 2.0))

    def op_time(self, op, eff) -> float:
        if op.duration_s is not None:
            return op.duration_s
        if op.flops <= 0.0:
            return 0.0
        t = op.flops / (eff.peak_flops * self.utilization(op.tile))
        if (self.im2col and op.op_kind == "conv" and op.tile
                and len(op.tile) >= 3):
            patch_bytes = 4.0 * float(op.tile[0]) * float(op.tile[2])
            extra = patch_bytes - op.bytes_in
            if extra > 0.0:
                t += extra / eff.hbm_bw
        return t


@dataclass(frozen=True)
class TableBackend:
    """Measured-sample lookup: ``(op_kind, flops, seconds)`` tuples.

    Pricing is log-log interpolation over the samples of the op's
    ``op_kind`` (falling back to the ``""`` kind, then to all samples
    pooled), clamped at the measured range's ends.  An op whose flops
    exactly matches a sample returns the measured seconds exactly (the
    round trip ``kernels/calibrate.py`` asserts).  Not smooth in the
    hardware parameter vector (the measured seconds do not move with
    ``peak_flops``): the event engine prices it exactly."""

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
        if op.duration_s is not None:
            return op.duration_s
        if op.flops <= 0.0:
            return 0.0
        return self._lookup(op.op_kind, op.flops)


ROOFLINE = RooflineBackend()

_NAMED = {"roofline": lambda: ROOFLINE,
          "systolic": SystolicBackend}


def is_roofline(backend) -> bool:
    """True when ``backend`` prices exactly like the engine's inline
    roofline math (the ``None`` default or an explicit
    :class:`RooflineBackend`)."""
    return (backend is None or backend == "roofline"
            or isinstance(backend, RooflineBackend))


def get_backend(spec) -> CostBackend:
    """Resolve a ``cost_backend`` field value to a backend instance.

    ``None`` / ``"roofline"`` -> the shared :data:`ROOFLINE`;
    ``"systolic"`` -> a default :class:`SystolicBackend`; any object with
    an ``op_time`` method passes through."""
    if spec is None:
        return ROOFLINE
    if isinstance(spec, str):
        try:
            return _NAMED[spec]()
        except KeyError:
            raise ValueError(f"unknown cost backend {spec!r}; one of "
                             f"{sorted(_NAMED)} (or a CostBackend "
                             "instance)") from None
    if not hasattr(spec, "op_time"):
        raise TypeError(f"cost_backend must be a name or CostBackend, "
                        f"got {type(spec).__name__}")
    return spec


# ---------------------------------------------------------------------------
# calibration: least-squares fit of roofline-shaped parameters to
# measured samples


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
