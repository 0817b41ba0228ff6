"""Trace-driven serving simulation: request arrivals, batching, the engine.

SMAUG's core claim is that end-to-end behavior — queueing, data movement
and framework overhead *around* the accelerator — dominates what per-layer
kernel models predict.  This module extends that argument from a single
request to a served workload: a trace of requests (arrival time, prompt
length, output length) is replayed against a batching policy
(``repro_torch.serve.policy``), every scheduler iteration is lowered to
costed ops via ``ir.from_serving_step``, and the chained step programs run
through the event engine — so one simulation yields per-request
latency (TTFT / TPOT / p50 / p99), throughput and batch occupancy
*alongside* the existing Timeline / Breakdown / Roofline / energy views.

The pieces:

  ``Request`` / ``poisson_trace`` / ``bursty_trace``
      synthetic workload generators (seeded, fully deterministic) plus a
      loadable record format (``load_trace`` / ``save_trace`` /
      ``trace_from_records``: JSON or JSON-lines with ``arrival_s``,
      ``prompt_len``, ``output_len`` fields);
  ``simulate_serving(cfg, trace, policy, config)``
      the scheduler co-simulation (below), returning a ``ServingResult``;
  ``serving_sweep`` / ``as_serving_records``
      the policy x arrival-rate design-space grid, one ``ServingResult``
      per cell, flattened to tidy records like ``sweep.as_records``.

How the co-simulation works.  Batching decisions depend on simulated time
(arrivals race batch completions), so the scheduler advances its own clock
while it builds the program: each iteration it forms a step per the
policy, lowers it with ``ir.from_serving_step``, and advances time by the
step's cost from ``engine.chain_op_costs`` — the exact per-op terms of the
engine's chain fast path, added in the engine's addition order.  The
chained steps form a pure linear chain, so when the finished program runs
through ``sweep()`` the engine's makespan equals the scheduler's
accumulated busy time *bit-for-bit* (asserted in
tests/test_torch_serving.py);
the wall clock additionally contains the idle gaps where the server waited
for arrivals, which exist only in the scheduler's timeline
(``ServingResult.makespan_s`` vs ``EngineResult.makespan``).

Same trace + same policy + same config => bit-identical ``ServingResult``
(the scheduler is deterministic and the engine already is).

Fleet scale.  Three additions let the same co-simulation replay
million-request traces across an N-replica fleet in seconds:

  ``StepCostTable``
      memoized exact step pricing.  ``ir.from_serving_step`` reads a
      step's composition only through the signature
      ``(prefill-length tuple, decode batch, decode position sum)``
      (see ``ir.serving_step_signature``), and ``engine.chain_op_costs``
      is pure in (op fields, config) — so each distinct signature is
      priced once via ``costmodel``'s per-op chain terms and every
      repeat is an O(1) dict hit, bit-identical to the unmemoized path;
  ``replay_serving`` / ``_Replica``
      the lite fast path: the identical scheduler state machine
      re-expressed over aggregate counters (live count, position sum, a
      finish heap) with no op materialization and no engine run —
      O(1) Python work per step regardless of batch size, bit-identical
      wall/busy clocks and per-request times (asserted in
      tests/test_torch_fleet.py);
  ``simulate_fleet`` / ``FleetResult``
      N ``_Replica`` schedulers behind a router
      (``repro_torch.serve.policy``: round_robin / least_outstanding /
      session_affinity) and an optional queue-depth autoscaler, rolled
      up into SLO attainment, cost-per-token (energy model) and
      scale-up/down events.

``diurnal_trace`` (sinusoidal-rate arrivals), ``TraceArrays`` (columnar
traces, no per-request objects) and ``iter_trace`` (lazy ``.jsonl[.gz]``
streaming) feed the fleet path at 1M-request scale; ``chip_smoke.py``'s
phase 28 logs the replay rate of a 100,000-request diurnal trace.

The port's copy of ``repro/sim/serving.py``: numpy and the standard
library, no torch.  Every scalar formula keeps the reference's
floating-point operation order, which is what keeps ``busy_s`` equal to
``engine.makespan`` bit for bit; ``tests/test_torch_serving.py`` and
``tests/test_torch_fleet.py`` hold it against the reference with ``==``.
"""
from __future__ import annotations

import gzip
import json
from collections import deque
from dataclasses import dataclass, field
from heapq import heappop, heappush
from itertools import chain as _chain
from typing import Deque, Dict, Iterable, Iterator, List, Optional, \
    Sequence, Tuple, Union

from repro_torch.core.energy import EnergyModel
from repro_torch.core.timeline import Timeline
from repro_torch.serve.policy import BatchingPolicy, QueueDepthAutoscaler, \
    RouterPolicy, StaticBatching, get_router
from repro_torch.sim import costmodel, engine, ir
from repro_torch.sim.engine import EngineConfig, EngineResult
from repro_torch.sim.ir import Program
from repro_torch.sim.report import latency_stats_array

__all__ = [
    "Request", "RequestMetrics", "StepRecord", "ServingResult",
    "ReplayResult", "FleetResult", "ScaleEvent", "StepCostTable",
    "TraceArrays", "poisson_trace", "bursty_trace", "diurnal_trace",
    "trace_from_records", "load_trace", "save_trace", "iter_trace",
    "simulate_serving", "replay_serving", "simulate_fleet",
    "serving_sweep", "as_serving_records", "as_fleet_records",
]


# ---------------------------------------------------------------------------
# the request trace


@dataclass(frozen=True)
class Request:
    """One serving request: when it arrives and how much work it is."""
    rid: int
    arrival_s: float
    prompt_len: int
    output_len: int


_Len = Union[int, Tuple[int, int]]

# name -> generator, the ``trace_kind`` registry shared by serving_sweep
# and apps.serving.serve_trace (populated after the generators below)
TRACE_GENERATORS: Dict[str, object] = {}


def _draw_len(rng, spec: _Len, n: int):
    if isinstance(spec, int):
        return [spec] * n
    lo, hi = spec
    return [int(v) for v in rng.integers(lo, hi + 1, size=n)]


def poisson_trace(n_requests: int, rate_rps: float, *,
                  prompt_len: _Len = (16, 128), output_len: _Len = (8, 64),
                  seed: int = 0) -> List[Request]:
    """Poisson arrivals at ``rate_rps`` requests/s; prompt and output
    lengths uniform over inclusive ``(lo, hi)`` ranges (or fixed ints).
    Seeded and deterministic: the same arguments always yield the same
    trace."""
    import numpy as np
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests)
    arrivals = np.cumsum(gaps)
    plens = _draw_len(rng, prompt_len, n_requests)
    olens = _draw_len(rng, output_len, n_requests)
    return [Request(i, float(arrivals[i]), max(plens[i], 1),
                    max(olens[i], 1)) for i in range(n_requests)]


def bursty_trace(n_requests: int, rate_rps: float, *, burst_size: int = 8,
                 burst_factor: float = 10.0, prompt_len: _Len = (16, 128),
                 output_len: _Len = (8, 64), seed: int = 0) -> List[Request]:
    """Bursty arrivals: groups of ``burst_size`` requests arrive at
    ``burst_factor``x the base rate, separated by exponential lulls of mean
    ``burst_size / rate_rps`` — the long-run rate stays near ``rate_rps``
    but queue depth spikes, which is what separates admission policies."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = 0.0
    arrivals = []
    for i in range(n_requests):
        if i and i % burst_size == 0:
            t += float(rng.exponential(burst_size / rate_rps))
        else:
            t += float(rng.exponential(1.0 / (rate_rps * burst_factor)))
        arrivals.append(t)
    plens = _draw_len(rng, prompt_len, n_requests)
    olens = _draw_len(rng, output_len, n_requests)
    return [Request(i, arrivals[i], max(plens[i], 1), max(olens[i], 1))
            for i in range(n_requests)]


@dataclass(frozen=True)
class TraceArrays:
    """Columnar (struct-of-arrays) trace: numpy columns instead of one
    ``Request`` object per row — the allocation-free input format
    ``replay_serving`` / ``simulate_fleet`` want at 1M-request scale
    (``diurnal_trace(..., arrays=True)`` produces it).  Iterating yields
    ``Request`` objects, so it also feeds ``simulate_serving`` and
    ``save_trace`` unchanged."""
    arrival_s: object            # (n,) float64
    prompt_len: object           # (n,) int64, >= 1
    output_len: object           # (n,) int64, >= 1
    rid: object                  # (n,) int64, unique

    def __len__(self) -> int:
        return len(self.rid)

    def __iter__(self) -> Iterator[Request]:
        a, r, p, o = (self.arrival_s.tolist(), self.rid.tolist(),
                      self.prompt_len.tolist(), self.output_len.tolist())
        for i in range(len(r)):
            yield Request(r[i], a[i], p[i], o[i])

    def columns(self) -> Tuple[list, list, list, list]:
        """(arrival_s, rid, prompt_len, output_len) as plain Python
        lists, sorted by (arrival_s, rid) and duplicate-rid checked —
        the scheduler-ready form."""
        import numpy as np
        a = np.asarray(self.arrival_s, dtype=np.float64)
        r = np.asarray(self.rid, dtype=np.int64)
        p = np.asarray(self.prompt_len, dtype=np.int64)
        o = np.asarray(self.output_len, dtype=np.int64)
        if np.unique(r).size != r.size:
            raise ValueError("duplicate rid in trace; per-request metrics "
                             "are keyed on it")
        order = np.lexsort((r, a))
        a, r, p, o = a[order], r[order], p[order], o[order]
        return a.tolist(), r.tolist(), p.tolist(), o.tolist()


def diurnal_trace(n_requests: int, rate_rps: float, *,
                  period_s: Optional[float] = None, amplitude: float = 0.8,
                  prompt_len: _Len = (16, 128), output_len: _Len = (8, 64),
                  seed: int = 0, arrays: bool = False
                  ) -> Union[List[Request], TraceArrays]:
    """Diurnal (sinusoidal-rate) arrivals: an inhomogeneous Poisson
    process with ``rate(t) = rate_rps * (1 + amplitude*sin(2*pi*t /
    period_s))`` — the day/night load curve a fleet autoscaler is sized
    against.  Generated by inverting the cumulative rate function on a
    fine grid (seeded, fully deterministic); ``period_s`` defaults to the
    expected trace span ``n_requests / rate_rps`` (one full "day" per
    trace); ``amplitude`` must sit in [0, 1).  ``arrays=True`` returns
    the columnar ``TraceArrays`` view (no per-request objects — the
    fleet-replay fast input)."""
    import numpy as np
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    rng = np.random.default_rng(seed)
    # unit-rate Poisson clock, warped through the inverse cumulative rate
    u = np.cumsum(rng.exponential(1.0, size=n_requests))
    period = float(period_s) if period_s else \
        max(n_requests / rate_rps, 1e-9)
    t_max = (float(u[-1]) if n_requests else 1.0) / rate_rps + period
    grid = np.linspace(0.0, t_max, 65536)
    # Lambda(t) = integral of rate(t'); >= rate*t, so the grid covers u
    lam = rate_rps * (grid + amplitude * (period / (2.0 * np.pi))
                      * (1.0 - np.cos(2.0 * np.pi * grid / period)))
    arrivals = np.interp(u, lam, grid)
    plens = np.maximum(np.asarray(_draw_len(rng, prompt_len, n_requests),
                                  dtype=np.int64), 1)
    olens = np.maximum(np.asarray(_draw_len(rng, output_len, n_requests),
                                  dtype=np.int64), 1)
    if arrays:
        return TraceArrays(arrival_s=arrivals, prompt_len=plens,
                           output_len=olens,
                           rid=np.arange(n_requests, dtype=np.int64))
    a, p, o = arrivals.tolist(), plens.tolist(), olens.tolist()
    return [Request(i, a[i], p[i], o[i]) for i in range(n_requests)]


TRACE_GENERATORS.update(poisson=poisson_trace, bursty=bursty_trace,
                        diurnal=diurnal_trace)


def _record_request(r: Dict, i: int) -> Request:
    return Request(int(r.get("rid", i)), float(r["arrival_s"]),
                   max(int(r["prompt_len"]), 1),
                   max(int(r["output_len"]), 1))


def trace_from_records(records: Sequence[Dict]) -> List[Request]:
    """Build a trace from dict records with ``arrival_s`` / ``prompt_len``
    / ``output_len`` keys (``rid`` optional; defaults to record order).
    Raises ValueError on duplicate rids — per-request metrics are keyed on
    them."""
    trace = [_record_request(r, i) for i, r in enumerate(records)]
    if len({r.rid for r in trace}) != len(trace):
        raise ValueError("duplicate rid in trace records")
    return trace


def _trace_opener(path):
    return gzip.open if str(path).endswith(".gz") else open


def iter_trace(path) -> Iterator[Request]:
    """Lazily yield ``Request``s from a trace file — JSON-lines (plain or
    ``.gz``) streams one record at a time, so a million-request trace is
    never materialized as dicts.  JSON-array files fall back to a full
    parse (the format has no line framing).  No duplicate-rid check here
    (that needs the full id set); ``load_trace`` adds it."""
    with _trace_opener(path)(path, "rt") as f:
        head = f.read(1)
        while head and head.isspace():
            head = f.read(1)
        if not head:
            return
        if head == "[":
            for i, r in enumerate(json.loads(head + f.read())):
                yield _record_request(r, i)
            return
        i = 0
        for line in _chain([head + f.readline()], f):
            line = line.strip()
            if line:
                yield _record_request(json.loads(line), i)
                i += 1


def load_trace(path) -> List[Request]:
    """Load a trace file into a list: a JSON array of records, or
    JSON-lines (one record per line), either optionally gzipped
    (``.jsonl.gz``).  Use ``iter_trace`` to stream without the list."""
    trace = list(iter_trace(path))
    if len({r.rid for r in trace}) != len(trace):
        raise ValueError("duplicate rid in trace records")
    return trace


def save_trace(path, trace: Iterable[Request]) -> None:
    """Write a trace as JSON-lines (the ``load_trace`` record format),
    gzipped when ``path`` ends in ``.gz``.  Accepts any iterable of
    ``Request`` — a generator or ``TraceArrays`` streams straight to
    disk without an intermediate list."""
    with _trace_opener(path)(path, "wt") as f:
        for r in trace:
            f.write(json.dumps({"rid": r.rid, "arrival_s": r.arrival_s,
                                "prompt_len": r.prompt_len,
                                "output_len": r.output_len}) + "\n")


def _trace_columns(trace) -> Tuple[list, list, list, list]:
    """Any trace form -> (arrival_s, rid, prompt_len, output_len) Python
    lists in (arrival_s, rid) order — what the replica schedulers
    consume.  Lists/tuples are sorted here; streamed iterators must
    already be arrival-sorted (they are consumed in one pass)."""
    if isinstance(trace, TraceArrays):
        return trace.columns()
    arr: List[float] = []
    rids: List[int] = []
    pls: List[int] = []
    ols: List[int] = []
    if isinstance(trace, (list, tuple)):
        ordered: Iterable[Request] = sorted(
            trace, key=lambda r: (r.arrival_s, r.rid))
    else:
        ordered = trace
    last = float("-inf")
    for rq in ordered:
        if rq.arrival_s < last:
            raise ValueError(
                "streamed trace must be sorted by arrival_s (pass a list "
                "to sort on entry, or sort the file first)")
        last = rq.arrival_s
        arr.append(rq.arrival_s)
        rids.append(rq.rid)
        pls.append(rq.prompt_len)
        ols.append(rq.output_len)
    if len(set(rids)) != len(rids):
        raise ValueError("duplicate rid in trace; per-request metrics are "
                         "keyed on it")
    return arr, rids, pls, ols


# ---------------------------------------------------------------------------
# results


@dataclass
class RequestMetrics:
    """Per-request outcome; all times are absolute wall-clock seconds."""
    rid: int
    arrival_s: float
    prompt_len: int
    output_len: int
    first_token_s: float = float("nan")
    finish_s: float = float("nan")

    @property
    def ttft_s(self) -> float:
        """Time to first token: arrival -> end of the prefill step."""
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> float:
        """Time per output token over the decode phase (0 for
        single-token outputs)."""
        if self.output_len <= 1:
            return 0.0
        return (self.finish_s - self.first_token_s) / (self.output_len - 1)

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s


@dataclass(frozen=True)
class StepRecord:
    """One scheduler iteration: where it sat in wall time and what it
    batched.  ``n_active`` counts decode slots that emitted a token;
    ``n_decode - n_active`` is padding (static batching's waste)."""
    index: int
    start_s: float
    duration_s: float
    n_prefill: int
    n_decode: int
    n_active: int

    @property
    def end_s(self) -> float:
        return self.start_s + self.duration_s


@dataclass
class ServingResult:
    """Everything one served-trace simulation produced.

    ``engine`` is the ordinary ``EngineResult`` of the chained step program
    (Timeline / Breakdown / Roofline / energy of the *work*, back-to-back);
    ``makespan_s`` is the serving wall clock, which additionally contains
    the idle gaps where the server waited for arrivals.  On any non-idle
    trace ``engine.makespan <= makespan_s``, with bit-exact equality of
    ``engine.makespan`` and ``busy_s``."""
    program: Program
    engine: EngineResult
    requests: List[RequestMetrics]
    steps: List[StepRecord]
    policy: BatchingPolicy
    config: EngineConfig
    makespan_s: float                 # wall clock: end of the last step
    busy_s: float                     # engine-order sum of step costs
    meta: Dict = field(default_factory=dict)

    @property
    def total_tokens(self) -> int:
        return sum(s.n_active for s in self.steps) \
            + sum(s.n_prefill for s in self.steps)

    @property
    def throughput_tok_s(self) -> float:
        """Output tokens per wall-clock second (prefill emits the first
        token of each request; decode emits the rest)."""
        return self.total_tokens / self.makespan_s if self.makespan_s \
            else 0.0

    @property
    def throughput_req_s(self) -> float:
        done = sum(1 for r in self.requests if r.finish_s == r.finish_s)
        return done / self.makespan_s if self.makespan_s else 0.0

    @property
    def occupancy(self) -> float:
        """Mean fraction of the ``max_batch`` decode slots that emitted a
        token, over steps that decoded at all — the batch-utilization view
        of the policy comparison."""
        decode_steps = [s for s in self.steps if s.n_decode]
        if not decode_steps:
            return 0.0
        return sum(s.n_active for s in decode_steps) \
            / (self.policy.max_batch * len(decode_steps))

    def stats(self) -> Dict[str, float]:
        """Tidy scalar summary (the ``as_serving_records`` row body)."""
        out: Dict[str, float] = {
            "n_requests": len(self.requests),
            "n_steps": len(self.steps),
            "makespan_s": self.makespan_s,
            "busy_s": self.busy_s,
            "throughput_tok_s": self.throughput_tok_s,
            "throughput_req_s": self.throughput_req_s,
            "occupancy": self.occupancy,
        }
        # latency_stats_array is bit-identical to the pure-python
        # latency_stats on these populations (see report.py), just O(n)
        # C-speed — the BENCH_serving.json grid values are unchanged
        for nm, vals in (("ttft", [r.ttft_s for r in self.requests]),
                         ("tpot", [r.tpot_s for r in self.requests
                                   if r.output_len > 1]),
                         ("latency", [r.latency_s for r in self.requests])):
            for k, v in latency_stats_array(vals).items():
                if k != "n":
                    out[f"{nm}_{k}"] = v
        return out

    def wall_timeline(self) -> Timeline:
        """Wall-clock step timeline (arrival gaps visible as idle), one
        event per scheduler step — the serving analogue of the engine's
        per-op Timeline."""
        tl = Timeline()
        for s in self.steps:
            tl.add("serve", f"step{s.index}", s.start_s, s.duration_s,
                   "compute", phase=f"step{s.index}")
        return tl


def _population_stats(arrival, olen, first, finish) -> Dict[str, float]:
    """ttft_*/tpot_*/latency_* percentile fields from metric arrays —
    elementwise identical to the ``RequestMetrics`` properties, then
    through the same ``latency_stats_array`` summaries."""
    import numpy as np
    arrival = np.asarray(arrival, dtype=np.float64)
    olen = np.asarray(olen, dtype=np.int64)
    first = np.asarray(first, dtype=np.float64)
    finish = np.asarray(finish, dtype=np.float64)
    ttft = first - arrival
    lat = finish - arrival
    multi = olen > 1
    tpot = ((finish - first) / np.maximum(olen - 1, 1))[multi]
    out: Dict[str, float] = {}
    for nm, vals in (("ttft", ttft), ("tpot", tpot), ("latency", lat)):
        for k, v in latency_stats_array(vals).items():
            if k != "n":
                out[f"{nm}_{k}"] = v
    return out


@dataclass
class ReplayResult:
    """What the lite fast path (``replay_serving`` / one fleet replica)
    produced: per-request metric arrays plus the scalar aggregates the
    full ``ServingResult`` would derive — but no op Program and no
    ``EngineResult`` (that is where the 10x+ comes from).  The scheduling
    and clock arithmetic are bit-identical to ``simulate_serving``
    (``stats()`` returns the exact same dict); the energy roll-up mirrors
    the engine's formula on the memoized per-op aggregates, equal to the
    full path up to float summation order."""
    name: str
    policy: BatchingPolicy
    config: EngineConfig
    rid: object                    # (n,) int64, trace order
    arrival_s: object              # (n,) float64
    prompt_len: object             # (n,) int64
    output_len: object             # (n,) int64
    first_token_s: object          # (n,) float64 (NaN = never prefilled)
    finish_s: object               # (n,) float64 (NaN = never finished)
    makespan_s: float              # wall clock: end of the last step
    busy_s: float                  # engine-order sum of step costs
    n_steps: int
    decode_steps: int              # steps with a decode op
    decode_slot_steps: int         # sum of n_decode over steps
    prefill_tokens: int            # first tokens emitted (= admissions)
    active_tokens: int             # decode tokens emitted
    flops: float                   # program flops (memoized aggregate)
    transfer_j: float              # interface transfer energy (J)
    steps: Optional[List[StepRecord]] = None
    meta: Dict = field(default_factory=dict)

    @property
    def n_requests(self) -> int:
        return len(self.rid)

    @property
    def requests(self) -> List[RequestMetrics]:
        """Materialized per-request metrics (lazy — fleet-scale callers
        stay on the arrays)."""
        a, p, o = (self.arrival_s.tolist(), self.prompt_len.tolist(),
                   self.output_len.tolist())
        fi, fo, rid = (self.first_token_s.tolist(), self.finish_s.tolist(),
                       self.rid.tolist())
        return [RequestMetrics(rid[i], a[i], p[i], o[i], fi[i], fo[i])
                for i in range(len(rid))]

    @property
    def total_tokens(self) -> int:
        return self.active_tokens + self.prefill_tokens

    @property
    def throughput_tok_s(self) -> float:
        return self.total_tokens / self.makespan_s if self.makespan_s \
            else 0.0

    @property
    def throughput_req_s(self) -> float:
        import numpy as np
        done = int(np.count_nonzero(self.finish_s == self.finish_s))
        return done / self.makespan_s if self.makespan_s else 0.0

    @property
    def occupancy(self) -> float:
        if not self.decode_steps:
            return 0.0
        return self.active_tokens \
            / (self.policy.max_batch * self.decode_steps)

    def energy(self) -> Dict[str, float]:
        """The engine's energy roll-up on the memoized aggregates
        (compute + interface transfers + static leakage over the busy
        span + host floor; serving steps move no collective bytes).
        Matches ``EngineResult.energy`` of the full path to within float
        summation order."""
        em = self.config.energy
        comp = em.compute(self.flops)
        static = em.static(self.busy_s + self.config.host_floor_s, 1)
        total = comp + self.transfer_j + static
        return {"compute_j": comp, "hbm_j": self.transfer_j,
                "ici_j": 0.0, "static_j": static, "total_j": total,
                "total_j_all_chips": total * self.config.n_chips}

    def stats(self) -> Dict[str, float]:
        """Tidy scalar summary — the exact dict ``ServingResult.stats``
        returns for the same (trace, policy, config)."""
        out: Dict[str, float] = {
            "n_requests": self.n_requests,
            "n_steps": self.n_steps,
            "makespan_s": self.makespan_s,
            "busy_s": self.busy_s,
            "throughput_tok_s": self.throughput_tok_s,
            "throughput_req_s": self.throughput_req_s,
            "occupancy": self.occupancy,
        }
        out.update(_population_stats(self.arrival_s, self.output_len,
                                     self.first_token_s, self.finish_s))
        return out


# ---------------------------------------------------------------------------
# memoized step pricing


def _require_uniform_pool(config: EngineConfig) -> None:
    if not engine.uniform_class_params(config, "accel"):
        raise ValueError(
            "serving co-simulation requires a uniform accelerator pool: "
            "the topology's accel-class devices resolve to more than one "
            "cost signature/link, so chain_op_costs cannot price ops "
            "exactly as the engine would charge them")


class StepCostTable:
    """Memoized exact pricing of serving-step ops.

    ``ir.from_serving_step`` determines every op cost field from the
    signature ``(prefill-length tuple, decode batch, decode position
    sum)`` — see ``ir.serving_step_signature`` — and
    ``engine.chain_op_costs`` is pure in (op fields, config).  The table
    therefore keeps two sub-caches: prefill-op entries keyed on the
    exact prompt-length tuple (the causal-attention term is an
    order-dependent float sum over individual lengths) and decode-op
    entries keyed on ``(batch, position sum, weights-charged)`` — so the
    scheduler loop prices a repeated step with one dict hit instead of a
    lowering + two cost evaluations.

    Misses are priced at the scalar parameter point
    ``costmodel.chain_params_for(config)`` using the same formulas (and
    IEEE operation order) as ``costmodel.chain_terms`` /
    ``engine.chain_op_costs``, so memoized costs are bit-identical to
    the unmemoized path (asserted against ``chain_op_costs`` over random
    compositions in tests/test_torch_fleet.py).  Interfaces or energy models
    outside the analytic chain model fall back to pricing each miss
    through ``engine.chain_op_costs`` itself — still memoized, still
    exact.

    Entries are ``(host_s, transfer_s, compute_s, collective_s, flops,
    transfer_j)`` per op.  One table can be shared across every replica
    and sweep cell that uses the same (model, config, bytes_per_param) —
    ``matches()`` guards the reuse."""

    def __init__(self, cfg, config: Optional[EngineConfig] = None, *,
                 bytes_per_param: float = 2.0):
        if config is None:
            config = EngineConfig()
        _require_uniform_pool(config)
        self.cfg = cfg
        self.config = config
        self.bytes_per_param = bytes_per_param
        (self.n_active, self.kv_dim, self.n_attn,
         self.weight_bytes) = ir._decode_terms(cfg, bytes_per_param)
        self.kv_entry = self.kv_dim * self.n_attn * bytes_per_param
        self._eff, self._ports = engine._class_params(config, "accel")
        try:
            self._p = costmodel.chain_params_for(config, "accel")
        except costmodel.Unsupported:
            self._p = None
        # the closed-form scalar pricer covers the hbm/ideal interfaces
        # with the stock energy model; dma/acp/custom miss through
        # chain_op_costs (identical numbers, a slower miss path)
        self._fast = (self._p is not None
                      and self._eff.interface in ("hbm", "ideal")
                      and type(config.energy) is EnergyModel)
        self._prefill: Dict[Tuple[int, ...], tuple] = {}
        self._decode: Dict[Tuple[int, int, bool], tuple] = {}
        self.hits = 0
        self.misses = 0

    def matches(self, cfg, config: EngineConfig,
                bytes_per_param: float) -> bool:
        """Whether this table prices (cfg, config, bytes_per_param) —
        reuse across replicas/cells is only exact when it does."""
        return (self.cfg is cfg and self.config == config
                and float(self.bytes_per_param) == float(bytes_per_param))

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def _price(self, flops: float, bytes_in: float,
               bytes_out: float) -> tuple:
        """One op -> (host, transfer, compute, collective, flops,
        transfer_j); serving ops always have dot_flops == flops and no
        duration/transfer overrides."""
        nb = bytes_in + bytes_out
        p = self._p
        if self._fast:
            # scalar costmodel.chain_terms, hbm/ideal branch — division
            # and max order identical to engine._transfer_base
            host = p.host_dispatch_s + (nb / p.host_bw / p.host_threads
                                        if p.host_bw else 0.0)
            expo = 0.0
            xe = 0.0
            if p.interface == "hbm" and nb:
                t = nb / p.hbm_bw
                xe = nb * p.pj_hbm * 1e-12
                t /= p.datapath_scale
                expo = (max(t - flops / p.peak_flops, 0.0)
                        if p.overlap else t)
                if expo > 0.0 and p.hbm_ports > 0:
                    expo *= max(1.0, 1 / p.hbm_ports)
            return (host, expo, flops / p.peak_flops, 0.0, flops, xe)
        op = ir.CostedOp(name="memo", flops=flops, dot_flops=flops,
                         bytes_in=bytes_in, bytes_out=bytes_out,
                         device_class="accel")
        h, x, c, l = engine.chain_op_costs(op, self.config)
        _, _, xe = engine._transfer_base(
            op, self._eff, engine.INTERFACES[self._eff.interface])
        return (h, x, c, l, flops, xe)

    def _prefill_entry(self, prefill_lens: Tuple[int, ...]) -> tuple:
        # field formulas (and float op order) of ir.from_serving_step
        n_tok = float(sum(prefill_lens))
        attn = sum(4.0 * self.n_attn * self.kv_dim * (L * (L - 1) // 2)
                   for L in prefill_lens)
        flops = 2.0 * self.n_active * n_tok + attn
        return self._price(flops, self.weight_bytes, self.kv_entry * n_tok)

    def _decode_entry(self, n_decode: int, pos_sum: int,
                      charge_weights: bool) -> tuple:
        batch = float(n_decode)
        ps = float(pos_sum)
        flops = 2.0 * self.n_active * batch \
            + 4.0 * self.n_attn * self.kv_dim * ps
        kv_read = 2.0 * self.n_attn * self.kv_dim * ps \
            * self.bytes_per_param
        bytes_in = (self.weight_bytes if charge_weights else 0.0) + kv_read
        return self._price(flops, bytes_in, self.kv_entry * batch)

    def step_entries(self, prefill_lens: Tuple[int, ...], n_decode: int,
                     pos_sum: int) -> tuple:
        """Per-op cost entries of the step with this signature, in the
        op order of ``ir.from_serving_step`` (prefill, then decode)."""
        pe = None
        if prefill_lens:
            pe = self._prefill.get(prefill_lens)
            if pe is None:
                self.misses += 1
                pe = self._prefill_entry(prefill_lens)
                self._prefill[prefill_lens] = pe
            else:
                self.hits += 1
        if n_decode:
            key = (n_decode, pos_sum, pe is None)
            de = self._decode.get(key)
            if de is None:
                self.misses += 1
                de = self._decode_entry(n_decode, pos_sum, pe is None)
                self._decode[key] = de
            else:
                self.hits += 1
            return (pe, de) if pe is not None else (de,)
        return (pe,) if pe is not None else ()


# ---------------------------------------------------------------------------
# the scheduler co-simulation


@dataclass
class _Slot:
    req: Request
    produced: int = 0     # output tokens emitted so far
    pos: int = 0          # current KV length (prompt written at prefill)

    @property
    def done(self) -> bool:
        return self.produced >= self.req.output_len


def simulate_serving(cfg, trace: Sequence[Request],
                     policy: BatchingPolicy,
                     config: Optional[EngineConfig] = None, *,
                     bytes_per_param: float = 2.0,
                     max_steps: int = 1_000_000,
                     memoize: bool = True,
                     table: Optional[StepCostTable] = None,
                     name: str = "") -> ServingResult:
    """Replay ``trace`` against ``policy`` on ``config``; see the module
    header for the co-simulation semantics.

    ``cfg`` is a ``repro_torch.core.config.ModelConfig`` (the served
    model);
    ``config`` defaults to a fresh ``EngineConfig()`` (``None`` sentinel —
    no shared module-level instance); ``bytes_per_param`` matches
    ``ir.from_decode``.  Raises RuntimeError past ``max_steps`` iterations
    (a policy that stops making progress).

    ``memoize=True`` (default) prices repeated step signatures through a
    ``StepCostTable`` — bit-identical results, one dict hit instead of
    two ``chain_op_costs`` calls per repeated step; pass ``table`` to
    share a warm cache across calls, or ``memoize=False`` for the
    original per-op pricing loop (the benchmark baseline).

    Heterogeneous topologies are supported as long as the accelerator
    pool is uniform (one cost signature + link across the class's
    candidate devices): ``chain_op_costs`` prices each op at the class's
    reference device, so a mixed pool would silently break the
    busy_s == engine.makespan invariant — it is rejected instead."""
    if config is None:
        config = EngineConfig()
    _require_uniform_pool(config)
    if table is not None:
        if not table.matches(cfg, config, bytes_per_param):
            raise ValueError("StepCostTable was built for a different "
                             "(model, config, bytes_per_param)")
    elif memoize:
        table = StepCostTable(cfg, config, bytes_per_param=bytes_per_param)
    trace = sorted(trace, key=lambda r: (r.arrival_s, r.rid))
    if len({r.rid for r in trace}) != len(trace):
        raise ValueError("duplicate rid in trace; per-request metrics are "
                         "keyed on it")
    metrics = {r.rid: RequestMetrics(r.rid, r.arrival_s, r.prompt_len,
                                     r.output_len) for r in trace}
    static = isinstance(policy, StaticBatching) or policy.kind == "static"
    continuous = policy.kind == "continuous"

    all_ops: List[ir.CostedOp] = []
    prev_op: Optional[str] = None
    steps: List[StepRecord] = []
    waiting: List[Request] = []
    live: List[_Slot] = []
    i = 0                          # next un-arrived trace index
    t = 0.0                        # wall clock (includes arrival gaps)
    busy = 0.0                     # engine-order accumulation of op costs
    k = 0                          # step index
    stalled = 0                    # consecutive zero-progress idle loops

    while True:
        while i < len(trace) and trace[i].arrival_s <= t:
            waiting.append(trace[i])
            i += 1
        trace_done = i >= len(trace)

        # eviction: continuous/dynamic free slots at end-of-output; static
        # holds the formed batch (padding) until every member finishes
        if static:
            if live and all(s.done for s in live):
                live = []
        else:
            live = [s for s in live if not s.done]

        # admission
        admitted: List[Request] = []
        if continuous:
            free = policy.max_batch - len(live)
            if free > 0 and waiting:
                admitted, waiting = waiting[:free], waiting[free:]
        elif not live and waiting:
            oldest = waiting[0].arrival_s
            # the absolute-deadline comparison repeats the exact float
            # expression the idle-advance below lands on, so a batch
            # launched "at the deadline" cannot miss it to rounding
            if (policy.ready(len(waiting), t - oldest, trace_done)
                    or t >= policy.launch_deadline_s(oldest)):
                admitted = waiting[:policy.max_batch]
                waiting = waiting[policy.max_batch:]

        decode_slots = [s for s in live if s.produced >= 1
                        and (static or not s.done)]
        if not admitted and not decode_slots:
            # nothing runnable: advance to the next arrival or (dynamic)
            # the oldest waiter's launch deadline; done when neither exists
            nxt = []
            if i < len(trace):
                nxt.append(trace[i].arrival_s)
            if waiting:
                nxt.append(policy.launch_deadline_s(waiting[0].arrival_s))
            nxt = [x for x in nxt if x < float("inf")]
            if not nxt:
                break
            t_new = max(t, min(nxt))
            if t_new == t:
                stalled += 1
                if stalled > 2:
                    raise RuntimeError(
                        f"serving scheduler stalled at t={t} with "
                        f"{len(waiting)} waiting (policy {policy.kind!r})")
            else:
                stalled = 0
            t = t_new
            continue

        # lower this iteration and advance both clocks with the exact
        # chain-path costs (see engine.chain_op_costs); with a table the
        # costs come from the signature memo — same values bit-for-bit
        pf = tuple(r.prompt_len for r in admitted)
        dpos = tuple(s.pos for s in decode_slots)
        step_prog = ir.from_serving_step(
            cfg, step=k, prefill_lens=pf, decode_positions=dpos,
            bytes_per_param=bytes_per_param)
        if table is not None:
            costs = table.step_entries(pf, len(dpos), sum(dpos))
        else:
            costs = [engine.chain_op_costs(op, config)
                     for op in step_prog.ops]
        t0 = t
        for op, cost in zip(step_prog.ops, costs):
            if prev_op is not None and not op.deps:
                op = ir.replace(op, deps=(prev_op,))
            all_ops.append(op)
            prev_op = op.name
            h, x, c, l = cost[0], cost[1], cost[2], cost[3]
            t += h
            t += x
            t += c
            t += l
            busy += h
            busy += x
            busy += c
            busy += l

        n_active = 0
        for s in decode_slots:
            if not s.done:
                s.produced += 1
                n_active += 1
                if s.done:
                    metrics[s.req.rid].finish_s = t
            s.pos += 1          # padded static slots advance with the batch
        for r in admitted:
            slot = _Slot(r, produced=1, pos=r.prompt_len)
            metrics[r.rid].first_token_s = t
            if slot.done:
                metrics[r.rid].finish_s = t
            live.append(slot)
        steps.append(StepRecord(k, t0, t - t0, len(admitted),
                                len(decode_slots), n_active))
        k += 1
        if k > max_steps:
            raise RuntimeError(f"serving scheduler exceeded {max_steps} "
                               f"steps (policy {policy.kind!r})")

    program = Program(
        all_ops, name=name or f"{getattr(cfg, 'name', 'model')}"
        f"/serve-{policy.kind}x{len(trace)}", source="serving",
        meta={"policy": policy.kind, "max_batch": policy.max_batch,
              "n_requests": len(trace), "n_steps": len(steps)})
    # the chained steps are a pure linear chain -> the official run takes
    # the engine's prefix-sum fast path, through the sweep/DSE layer
    from repro_torch.sim.sweep import sweep
    (engine_res,) = sweep(program, [config])
    return ServingResult(program=program, engine=engine_res,
                         requests=[metrics[r.rid] for r in trace],
                         steps=steps, policy=policy, config=config,
                         makespan_s=t, busy_s=busy,
                         meta={"bytes_per_param": bytes_per_param})


# ---------------------------------------------------------------------------
# the lite fast path: aggregate-counter replicas + memoized step costs


class _Replica:
    """One replica's incremental scheduler — the exact
    ``simulate_serving`` state machine re-expressed over aggregate
    counters, driven by ``push`` (a routed arrival) and ``drain_until``
    (advance the replica's clock).

    Slot-by-slot state collapses to O(1)-per-step aggregates: ``n_live``
    (batch size), ``pos_sum`` (the integer KV-position sum — all the
    decode op needs, see ``ir.serving_step_signature``), ``n_emitting``
    (live slots still producing), and a finish heap of ``(finish_step,
    idx, evict_pos)`` — a slot admitted at step k with output length o
    emits its last token at step ``k + o - 1`` because every live slot
    decodes every step, so its eviction is known at admission.  Static
    batches hold finished slots as padding (their positions keep
    advancing inside ``pos_sum``) and clear wholesale when the last
    member finishes; single-token requests never enter the live batch
    under continuous/dynamic (they finish at prefill), exactly like the
    slot loop.  Clock arithmetic (idle jumps, per-term adds in op order)
    repeats the standalone loop's float expressions, so wall/busy clocks
    and per-request times are bit-identical
    (tests/test_torch_fleet.py)."""

    __slots__ = ("table", "policy", "static", "continuous", "max_batch",
                 "t", "busy", "k", "last_end", "waiting", "n_live",
                 "n_emitting", "pos_sum", "heap", "trace_done", "first",
                 "finish", "steps", "max_steps", "decode_steps",
                 "decode_slot_steps", "prefill_tokens", "active_tokens",
                 "flops", "transfer_j", "index", "spawn_s")

    def __init__(self, table: StepCostTable, policy: BatchingPolicy,
                 first: list, finish: list, *, t0: float = 0.0,
                 record_steps: bool = False,
                 max_steps: int = 100_000_000, index: int = 0):
        self.table = table
        self.policy = policy
        self.static = policy.kind == "static" \
            or isinstance(policy, StaticBatching)
        self.continuous = policy.kind == "continuous"
        self.max_batch = policy.max_batch
        self.t = t0
        self.spawn_s = t0
        self.busy = 0.0
        self.k = 0
        self.last_end = 0.0
        # (arrival_s, idx, plen, olen); deque: admission pops from the
        # left, so a deep backlog never costs O(queue) per step
        self.waiting: Deque[tuple] = deque()
        self.n_live = 0
        self.n_emitting = 0
        self.pos_sum = 0
        self.heap: List[tuple] = []      # (finish_step, idx, evict_pos)
        self.trace_done = False
        self.first = first               # shared sinks indexed by idx
        self.finish = finish
        self.steps: Optional[List[StepRecord]] = \
            [] if record_steps else None
        self.max_steps = max_steps
        self.decode_steps = 0
        self.decode_slot_steps = 0
        self.prefill_tokens = 0
        self.active_tokens = 0
        self.flops = 0.0
        self.transfer_j = 0.0
        self.index = index

    @property
    def outstanding(self) -> int:
        """Queued + still-emitting requests (what a router balances)."""
        return len(self.waiting) + self.n_emitting

    def push(self, arrival_s: float, idx: int, plen: int,
             olen: int) -> None:
        """Route one arrival here.  The caller must have drained this
        replica to ``arrival_s`` first; an idle replica's clock jumps
        forward to the arrival (the standalone loop's idle advance)."""
        if self.t < arrival_s:
            self.t = arrival_s
        self.waiting.append((arrival_s, idx, plen, olen))

    def drain_until(self, until_s: float) -> None:
        """Run every step that starts strictly before ``until_s``
        (``inf`` = drain completely).  Returns with ``t >= until_s``, or
        idle (nothing runnable before the next push)."""
        policy = self.policy
        while True:
            if self.t >= until_s:
                return
            waiting = self.waiting
            admitted: Optional[List[tuple]] = None
            if self.continuous:
                free = self.max_batch - self.n_live
                if free > 0 and waiting:
                    pop = waiting.popleft
                    admitted = [pop()
                                for _ in range(min(free, len(waiting)))]
            elif self.n_live == 0 and waiting:
                oldest = waiting[0][0]
                if (policy.ready(len(waiting), self.t - oldest,
                                 self.trace_done)
                        or self.t >= policy.launch_deadline_s(oldest)):
                    pop = waiting.popleft
                    admitted = [pop() for _ in
                                range(min(self.max_batch, len(waiting)))]
            if admitted or self.n_live:
                self._step(admitted or ())
                continue
            # idle: next arrival (if any) is >= until_s by protocol
            if not waiting:
                return
            dl = policy.launch_deadline_s(waiting[0][0])
            if dl >= until_s:
                return
            # jump to the launch deadline; the admission check above
            # repeats this exact float, so the batch launches next loop
            self.t = max(self.t, dl)

    def _step(self, admitted: Sequence[tuple]) -> None:
        pf = tuple(a[2] for a in admitted) if admitted else ()
        n_dec = self.n_live
        entries = self.table.step_entries(pf, n_dec, self.pos_sum)
        t = self.t
        t0 = t
        busy = self.busy
        for e in entries:
            t += e[0]
            t += e[1]
            t += e[2]
            t += e[3]
            busy += e[0]
            busy += e[1]
            busy += e[2]
            busy += e[3]
            self.flops += e[4]
            self.transfer_j += e[5]
        self.t = t
        self.busy = busy
        self.last_end = t
        k = self.k
        n_act = self.n_emitting
        if n_dec:
            self.pos_sum += n_dec        # every decode slot advances
            self.decode_steps += 1
            self.decode_slot_steps += n_dec
            self.active_tokens += n_act
            heap = self.heap
            while heap and heap[0][0] <= k:
                _, idx, evict_pos = heappop(heap)
                self.finish[idx] = t
                self.n_emitting -= 1
                if not self.static:
                    self.n_live -= 1
                    self.pos_sum -= evict_pos
        if admitted:
            self.prefill_tokens += len(admitted)
            first = self.first
            static = self.static
            for _, idx, plen, olen in admitted:
                first[idx] = t
                if olen <= 1:
                    self.finish[idx] = t
                    if static:               # stays as batch padding
                        self.n_live += 1
                        self.pos_sum += plen
                else:
                    self.n_live += 1
                    self.pos_sum += plen
                    self.n_emitting += 1
                    heappush(self.heap,
                             (k + olen - 1, idx, plen + olen - 1))
        if self.steps is not None:
            self.steps.append(StepRecord(k, t0, t - t0, len(admitted),
                                         n_dec, n_act))
        self.k = k + 1
        if self.k > self.max_steps:
            raise RuntimeError(
                f"serving scheduler exceeded {self.max_steps} steps "
                f"(policy {self.policy.kind!r})")
        # static: the batch drains as one (the loop-top wholesale clear)
        if self.static and self.n_live and self.n_emitting == 0:
            self.n_live = 0
            self.pos_sum = 0


def _replica_result(rep: _Replica, policy: BatchingPolicy,
                    config: EngineConfig, arrival, rid, plen, olen,
                    first, finish, *, name: str,
                    meta: Optional[Dict] = None) -> ReplayResult:
    import numpy as np
    return ReplayResult(
        name=name, policy=policy, config=config,
        rid=np.asarray(rid, dtype=np.int64),
        arrival_s=np.asarray(arrival, dtype=np.float64),
        prompt_len=np.asarray(plen, dtype=np.int64),
        output_len=np.asarray(olen, dtype=np.int64),
        first_token_s=np.asarray(first, dtype=np.float64),
        finish_s=np.asarray(finish, dtype=np.float64),
        makespan_s=rep.last_end, busy_s=rep.busy, n_steps=rep.k,
        decode_steps=rep.decode_steps,
        decode_slot_steps=rep.decode_slot_steps,
        prefill_tokens=rep.prefill_tokens,
        active_tokens=rep.active_tokens,
        flops=rep.flops, transfer_j=rep.transfer_j,
        steps=rep.steps, meta=dict(meta or {}))


def replay_serving(cfg, trace, policy: BatchingPolicy,
                   config: Optional[EngineConfig] = None, *,
                   bytes_per_param: float = 2.0,
                   record_steps: bool = False,
                   max_steps: int = 100_000_000,
                   table: Optional[StepCostTable] = None,
                   name: str = "") -> ReplayResult:
    """The memoized lite replay of ``simulate_serving``: identical
    scheduling and clock arithmetic (wall/busy clocks, step records and
    per-request times are bit-identical — asserted in
    tests/test_torch_fleet.py), but no op materialization and no engine
    run, so the cost per step is O(1) Python work plus a dict hit.  This
    is the path that replays 1M-request traces in seconds.

    ``trace`` may be a list/tuple of ``Request`` (sorted here), a
    ``TraceArrays`` column view, or an arrival-sorted iterator (e.g.
    ``iter_trace``).  Pass ``table`` to share a warm ``StepCostTable``
    across calls."""
    if config is None:
        config = EngineConfig()
    if table is not None:
        if not table.matches(cfg, config, bytes_per_param):
            raise ValueError("StepCostTable was built for a different "
                             "(model, config, bytes_per_param)")
    else:
        table = StepCostTable(cfg, config, bytes_per_param=bytes_per_param)
    arrival, rid, plen, olen = _trace_columns(trace)
    n = len(rid)
    nan = float("nan")
    first = [nan] * n
    finish = [nan] * n
    rep = _Replica(table, policy, first, finish,
                   record_steps=record_steps, max_steps=max_steps)
    drain = rep.drain_until
    push = rep.push
    for j in range(n):
        a = arrival[j]
        drain(a)
        push(a, j, plen[j], olen[j])
    rep.trace_done = True
    rep.drain_until(float("inf"))
    return _replica_result(
        rep, policy, config, arrival, rid, plen, olen, first, finish,
        name=name or f"{getattr(cfg, 'name', 'model')}"
        f"/replay-{policy.kind}x{n}",
        meta={"bytes_per_param": bytes_per_param,
              "memo_hits": table.hits, "memo_misses": table.misses})


# ---------------------------------------------------------------------------
# the fleet layer: N replicas behind a router (+ optional autoscaler)


@dataclass(frozen=True)
class ScaleEvent:
    """One autoscaler action: at ``t_s`` the fleet went to
    ``n_replicas`` active replicas because the mean queue depth per
    active replica was ``queue_depth``."""
    t_s: float
    action: str                  # "up" | "down"
    n_replicas: int              # active replicas AFTER the action
    queue_depth: float


@dataclass
class FleetResult:
    """An N-replica serving fleet's roll-up: per-replica
    ``ReplayResult``s plus the global request arrays, the routing
    assignment, autoscaler events, and fleet-level SLO / cost views."""
    name: str
    replicas: List[ReplayResult]
    router: RouterPolicy
    policy: BatchingPolicy
    config: EngineConfig
    rid: object                  # (n,) int64, trace order
    arrival_s: object
    prompt_len: object
    output_len: object
    first_token_s: object
    finish_s: object
    replica_of: object           # (n,) int64: replica index per request
    scale_events: List[ScaleEvent]
    makespan_s: float            # max replica wall clock
    meta: Dict = field(default_factory=dict)

    @property
    def n_requests(self) -> int:
        return len(self.rid)

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def busy_s(self) -> float:
        return sum(r.busy_s for r in self.replicas)

    @property
    def n_steps(self) -> int:
        return sum(r.n_steps for r in self.replicas)

    @property
    def total_tokens(self) -> int:
        return sum(r.total_tokens for r in self.replicas)

    @property
    def throughput_tok_s(self) -> float:
        return self.total_tokens / self.makespan_s if self.makespan_s \
            else 0.0

    @property
    def throughput_req_s(self) -> float:
        import numpy as np
        done = int(np.count_nonzero(self.finish_s == self.finish_s))
        return done / self.makespan_s if self.makespan_s else 0.0

    @property
    def occupancy(self) -> float:
        dsteps = sum(r.decode_steps for r in self.replicas)
        if not dsteps:
            return 0.0
        return sum(r.active_tokens for r in self.replicas) \
            / (self.policy.max_batch * dsteps)

    def energy(self) -> Dict[str, float]:
        """Component-wise sum of the replica energy roll-ups (each
        replica is one chip's worth of static power over its busy
        span)."""
        out: Dict[str, float] = {}
        for r in self.replicas:
            for kk, v in r.energy().items():
                out[kk] = out.get(kk, 0.0) + v
        return out

    def cost_per_token_j(self) -> float:
        """Joules per emitted token across the fleet — the energy-model
        cost the autoscaler trades against SLO attainment."""
        tok = self.total_tokens
        return self.energy()["total_j"] / tok if tok else 0.0

    def slo_attainment(self, ttft_slo_s: float = 0.5,
                       tpot_slo_s: float = 0.05) -> float:
        """Fraction of requests that finished AND met both the TTFT and
        (for multi-token outputs) the TPOT objective."""
        import numpy as np
        n = self.n_requests
        if not n:
            return 1.0
        finish = np.asarray(self.finish_s)
        first = np.asarray(self.first_token_s)
        olen = np.asarray(self.output_len)
        ok = np.isfinite(finish) \
            & ((first - np.asarray(self.arrival_s)) <= ttft_slo_s)
        tpot = np.where(olen > 1,
                        (finish - first) / np.maximum(olen - 1, 1), 0.0)
        ok &= ~(tpot > tpot_slo_s)       # NaN tpot already failed above
        return float(np.count_nonzero(ok)) / n

    def stats(self, *, ttft_slo_s: float = 0.5,
              tpot_slo_s: float = 0.05) -> Dict[str, float]:
        """Tidy scalar summary (the ``as_fleet_records`` row body)."""
        out: Dict[str, float] = {
            "n_requests": self.n_requests,
            "n_replicas": self.n_replicas,
            "n_steps": self.n_steps,
            "makespan_s": self.makespan_s,
            "busy_s": self.busy_s,
            "throughput_tok_s": self.throughput_tok_s,
            "throughput_req_s": self.throughput_req_s,
            "occupancy": self.occupancy,
            "slo_attainment": self.slo_attainment(
                ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s),
            "cost_per_token_j": self.cost_per_token_j(),
            "total_j": self.energy()["total_j"],
            "n_scale_events": len(self.scale_events),
        }
        out.update(_population_stats(self.arrival_s, self.output_len,
                                     self.first_token_s, self.finish_s))
        return out


def simulate_fleet(cfg, trace, policy: BatchingPolicy,
                   config: Optional[EngineConfig] = None, *,
                   n_replicas: int = 2,
                   router: Union[str, RouterPolicy] = "round_robin",
                   autoscaler: Optional[QueueDepthAutoscaler] = None,
                   bytes_per_param: float = 2.0,
                   record_steps: bool = False,
                   max_steps: int = 100_000_000,
                   table: Optional[StepCostTable] = None,
                   name: str = "") -> FleetResult:
    """Replay ``trace`` across an N-replica fleet: each arrival is routed
    to one ``_Replica`` scheduler (every replica runs the same batching
    ``policy`` on its own ``config``-worth of hardware), advanced
    incrementally to the arrival instant.  All replicas share one
    ``StepCostTable``, so the whole fleet prices steps out of one memo.

    ``router`` is a name or ``RouterPolicy`` (round_robin /
    least_outstanding / session_affinity).  Stateful routers (and any
    ``autoscaler``) drain every active replica to each arrival so queue
    depths are exact at routing time; stateless routers drain lazily.

    With a ``QueueDepthAutoscaler``, scale-up spawns a fresh replica at
    the arrival instant and scale-down retires the emptiest active
    replica — it finishes its queued work but receives no new requests.
    A replica that routed at least one request is never lost: retired
    and spawned replicas all report in ``FleetResult.replicas``.

    Each request is routed to exactly one replica and served exactly
    once (the conservation property asserted in
    tests/test_torch_fleet.py);
    with ``n_replicas=1`` and the round-robin router the result is
    bit-identical to ``replay_serving`` (and so to
    ``simulate_serving``)."""
    if config is None:
        config = EngineConfig()
    if isinstance(router, str):
        router = get_router(router)
    if table is not None:
        if not table.matches(cfg, config, bytes_per_param):
            raise ValueError("StepCostTable was built for a different "
                             "(model, config, bytes_per_param)")
    else:
        table = StepCostTable(cfg, config, bytes_per_param=bytes_per_param)
    arrival, rid, plen, olen = _trace_columns(trace)
    n = len(rid)
    nan = float("nan")
    first = [nan] * n
    finish = [nan] * n
    replica_of = [0] * n
    replicas: List[_Replica] = []

    def spawn(t0: float) -> _Replica:
        r = _Replica(table, policy, first, finish, t0=t0,
                     record_steps=record_steps, max_steps=max_steps,
                     index=len(replicas))
        replicas.append(r)
        return r

    n0 = max(1, int(n_replicas))
    if autoscaler is not None:
        n0 = min(max(n0, autoscaler.min_replicas),
                 autoscaler.max_replicas)
    active = [spawn(0.0) for _ in range(n0)]
    stateful = router.stateful or autoscaler is not None
    events: List[ScaleEvent] = []
    last_change = float("-inf")
    route = router.route

    for j in range(n):
        a = arrival[j]
        if stateful:
            outstanding = []
            for r in active:
                r.drain_until(a)
                outstanding.append(r.outstanding)
            if autoscaler is not None:
                depth = sum(outstanding) / len(active)
                act = autoscaler.decide(len(active), depth, a,
                                        last_change)
                if act > 0:
                    active.append(spawn(a))
                    outstanding.append(0)
                    last_change = a
                    events.append(ScaleEvent(a, "up", len(active), depth))
                elif act < 0:
                    i_min = min(range(len(active)),
                                key=outstanding.__getitem__)
                    active.pop(i_min)        # retires: drains, no routes
                    outstanding.pop(i_min)
                    last_change = a
                    events.append(ScaleEvent(a, "down", len(active),
                                             depth))
        else:
            outstanding = ()
        r = active[route(rid[j], j, outstanding) % len(active)]
        if not stateful:
            r.drain_until(a)
        r.push(a, j, plen[j], olen[j])
        replica_of[j] = r.index

    inf = float("inf")
    for r in replicas:
        r.trace_done = True
    for r in replicas:
        r.drain_until(inf)

    import numpy as np
    rid_a = np.asarray(rid, dtype=np.int64)
    arr_a = np.asarray(arrival, dtype=np.float64)
    pl_a = np.asarray(plen, dtype=np.int64)
    ol_a = np.asarray(olen, dtype=np.int64)
    fi_a = np.asarray(first, dtype=np.float64)
    fo_a = np.asarray(finish, dtype=np.float64)
    ro_a = np.asarray(replica_of, dtype=np.int64)
    base = name or f"{getattr(cfg, 'name', 'model')}" \
        f"/fleet-{router.kind}x{len(replicas)}"
    per: List[ReplayResult] = []
    for r in replicas:
        sel = np.nonzero(ro_a == r.index)[0]
        per.append(ReplayResult(
            name=f"{base}/r{r.index}", policy=policy, config=config,
            rid=rid_a[sel], arrival_s=arr_a[sel], prompt_len=pl_a[sel],
            output_len=ol_a[sel], first_token_s=fi_a[sel],
            finish_s=fo_a[sel], makespan_s=r.last_end, busy_s=r.busy,
            n_steps=r.k, decode_steps=r.decode_steps,
            decode_slot_steps=r.decode_slot_steps,
            prefill_tokens=r.prefill_tokens,
            active_tokens=r.active_tokens, flops=r.flops,
            transfer_j=r.transfer_j, steps=r.steps,
            meta={"replica": r.index, "spawn_s": r.spawn_s,
                  "retired": r not in active}))
    return FleetResult(
        name=base, replicas=per, router=router, policy=policy,
        config=config, rid=rid_a, arrival_s=arr_a, prompt_len=pl_a,
        output_len=ol_a, first_token_s=fi_a, finish_s=fo_a,
        replica_of=ro_a, scale_events=events,
        makespan_s=max((r.last_end for r in replicas), default=0.0),
        meta={"bytes_per_param": bytes_per_param,
              "memo_hits": table.hits, "memo_misses": table.misses,
              "memo_hit_rate": table.hit_rate})


# ---------------------------------------------------------------------------
# the policy x arrival-rate design-space grid


def serving_sweep(cfg, policies: Sequence[BatchingPolicy],
                  rates_rps: Sequence[float], *, n_requests: int = 64,
                  config: Optional[EngineConfig] = None,
                  trace_kind: str = "poisson", seed: int = 0,
                  bytes_per_param: float = 2.0,
                  **trace_kw) -> List[ServingResult]:
    """Evaluate every (policy, arrival-rate) cell on the SAME trace per
    rate (one seeded generator call per rate, shared across policies, so
    the comparison isolates the policy).  Returns results in
    ``for rate: for policy:`` order; each carries its cell coordinates in
    ``result.meta``."""
    if config is None:
        config = EngineConfig()
    gen = TRACE_GENERATORS[trace_kind]
    out: List[ServingResult] = []
    for rate in rates_rps:
        trace = gen(n_requests, rate, seed=seed, **trace_kw)
        for policy in policies:
            res = simulate_serving(cfg, trace, policy, config,
                                   bytes_per_param=bytes_per_param)
            res.meta.update({"rate_rps": rate, "policy": policy.kind,
                             "trace_kind": trace_kind, "seed": seed})
            out.append(res)
    return out


def as_serving_records(results: Sequence[Union[ServingResult,
                                               ReplayResult]]
                       ) -> List[Dict[str, float]]:
    """Flatten ``ServingResult``/``ReplayResult``s to tidy per-cell
    dicts (the serving analogue of ``sweep.as_records``).  Every row
    carries the same columns — ``rate_rps`` and ``trace_kind`` are
    always present (``None`` when the result did not come from a sweep
    cell), so downstream tables never KeyError on mixed provenance."""
    rows = []
    for r in results:
        if isinstance(r, ReplayResult):
            # the replay runs no engine; its busy clock IS the chained
            # program's makespan (bit-identical, see
            # tests/test_torch_fleet.py)
            program, makespan = r.name, r.busy_s
            total_j = r.energy()["total_j"]
        else:
            program, makespan = r.program.name, r.engine.makespan
            total_j = r.engine.energy["total_j"]
        row = {"program": program, "policy": r.policy.kind,
               "max_batch": r.policy.max_batch,
               "rate_rps": r.meta.get("rate_rps"),
               "trace_kind": r.meta.get("trace_kind"),
               "interface": r.config.interface,
               "engine_makespan_s": makespan,
               "total_j": total_j}
        row.update(r.stats())
        rows.append(row)
    return rows


def as_fleet_records(results: Sequence[FleetResult], *,
                     ttft_slo_s: float = 0.5, tpot_slo_s: float = 0.05,
                     per_replica: bool = False) -> List[Dict]:
    """Flatten ``FleetResult``s to tidy rows (one per fleet, or one per
    replica with ``per_replica=True``).  Fleet rows carry the SLO /
    cost-per-token roll-up; replica rows reuse ``as_serving_records``
    columns plus the fleet coordinates."""
    rows: List[Dict] = []
    for f in results:
        if per_replica:
            for rr in f.replicas:
                row = as_serving_records([rr])[0]
                row.update({"fleet": f.name, "router": f.router.kind,
                            "replica": rr.meta.get("replica"),
                            "rate_rps": f.meta.get("rate_rps"),
                            "trace_kind": f.meta.get("trace_kind")})
                rows.append(row)
            continue
        row = {"fleet": f.name, "router": f.router.kind,
               "policy": f.policy.kind,
               "max_batch": f.policy.max_batch,
               "rate_rps": f.meta.get("rate_rps"),
               "trace_kind": f.meta.get("trace_kind"),
               "interface": f.config.interface,
               "memo_hit_rate": f.meta.get("memo_hit_rate")}
        row.update(f.stats(ttft_slo_s=ttft_slo_s,
                           tpot_slo_s=tpot_slo_s))
        rows.append(row)
    return rows
