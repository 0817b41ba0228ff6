"""Batched design-space exploration: one program, many SoC configs.

SMAUG's case studies are *sweeps*: the same workload evaluated over a grid
of interface choices, worker counts, host-threading levels and datapath
sizes (Fig 11/14/15/16/20).  ``sweep(program, configs)`` runs that grid
without re-paying per-config costs:

  * the program is lowered once and its dependency bookkeeping
    (``engine.prepare``: ops / consumers / n_waiting / totals) is shared by
    every run instead of being rebuilt per config;
  * ``lower_graph`` memoizes the ``from_graph`` lowering keyed on (graph
    digest, batch, tile params), so benchmark loops that re-lower the same
    network hit a cache;
  * configs can be evaluated serially (fast engine + shared plan), across
    threads, or across processes (the program ships once per worker via
    the pool initializer, not once per config).

Results come back as a tidy list of ``EngineResult`` records, one per
config, in config order — the same objects ``engine.run`` returns.

On top of the exact grid sits the **analytic DSE layer**
(``repro_torch.sim.costmodel``): ``batched(program, configs)`` prices the
whole grid as one vectorized parameter matrix (bit-identical to the engine
on chain programs with numpy, a certified lower/upper bracket on DAGs) and
re-runs only the top-k winners through the exact engine;
``optimize(program, space)`` descends the same model with multi-start
gradient descent (``torch.func`` gradients on the torch backend, batched
central differences on numpy) and returns an exact-engine-verified design —
"the cheapest config meeting a latency target" is one call.

``fleet_sweep`` runs the serving fleet's router x replica-count grid
(``repro_torch.sim.serving``) out of one shared step-cost memo;
``training_sweep`` the pipeline schedule x stages x microbatches grid and
``cluster_sweep`` the DP x PP x TP placement x collective-algorithm grid
over ``hw.Fabric.cluster`` (``repro_torch.sim.training``), flattened by
``as_training_records`` / ``as_cluster_records`` (the latter with per-step
energy and TCO, ``hw.tco_per_step``).

The port's copy of ``repro/sim/sweep.py``.  Not copied yet: ``lower_hlo``
(it waits for an HLO lowering).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim import costmodel, engine, hw, ir
from repro_torch.sim.costmodel import CostModel, Unsupported
from repro_torch.sim.engine import EngineConfig, EngineResult
from repro_torch.sim.hw import PARAM_FIELDS, SoCTopology
from repro_torch.sim.ir import Program

__all__ = ["sweep", "batched", "optimize", "topology_sweep",
           "training_sweep", "fleet_sweep", "cluster_sweep",
           "placements_for", "lower_graph", "graph_digest", "clear_caches",
           "as_records", "as_training_records", "as_cluster_records",
           "BatchedSweep", "OptimizeResult"]

_CACHE_MAX = 64

# digest-keyed program cache, true LRU (a hit refreshes recency via
# move_to_end, eviction pops the least-recently-used entry).  Keying on a
# structural digest — not object identity — lets independently-built but
# identical graphs (fresh ``build_paper_graph`` calls) share one lowering.
_graph_cache: "OrderedDict[tuple, Program]" = OrderedDict()

# id -> (graph object, digest): ``from_graph`` backfills weight-derived
# attrs in place, so a graph's byte content changes after its first
# lowering; the digest is therefore computed once per *object* (the graph
# is retained so a recycled id can never alias) and reused verbatim.
_digest_memo: "OrderedDict[int, tuple]" = OrderedDict()


def graph_digest(g) -> str:
    """Stable structural digest of a ``repro_torch.core.graph.Graph``: name,
    backend, and every node's (name, op, inputs, shape, sorted attrs) in
    topological order.  Graphs built by the same recipe digest equal even
    when they are distinct objects."""
    key = id(g)
    hit = _digest_memo.get(key)
    if hit is not None and hit[0] is g:
        _digest_memo.move_to_end(key)
        return hit[1]
    import hashlib
    h = hashlib.sha256()
    h.update(f"{g.name}|{getattr(g, 'backend', '')}\n".encode())
    for name in g.order:
        n = g.nodes[name]
        attrs = ";".join(f"{k}={n.attrs[k]!r}" for k in sorted(n.attrs))
        h.update(f"{n.name}|{n.op}|{','.join(n.inputs)}|"
                 f"{tuple(n.shape)}|{attrs}\n".encode())
    d = h.hexdigest()
    if len(_digest_memo) >= _CACHE_MAX:
        _digest_memo.popitem(last=False)
    _digest_memo[key] = (g, d)
    return d


def lower_graph(g, batch: int = 1, max_tile_elems: int = 16384) -> Program:
    """Memoized ``ir.from_graph`` (tiled for the H100) keyed on (structural
    digest, batch, tile params) — equal graphs hit the cache even across
    distinct objects."""
    key = (graph_digest(g), int(batch), int(max_tile_elems))
    prog = _graph_cache.get(key)
    if prog is not None:
        _graph_cache.move_to_end(key)
        return prog
    prog = ir.from_graph(g, batch=batch, max_tile_elems=max_tile_elems)
    if len(_graph_cache) >= _CACHE_MAX:
        _graph_cache.popitem(last=False)
    _graph_cache[key] = prog
    return prog


def clear_caches() -> None:
    """Drop the memoized lowerings (tests and long-lived sessions that
    churn through many graphs; the LRU eviction above bounds memory for
    everyone else)."""
    _graph_cache.clear()
    _digest_memo.clear()


# ---------------------------------------------------------------------------
# process-pool plumbing: the program crosses the pickle boundary once per
# worker (initializer), then each task ships only its EngineConfig.

_proc_state: dict = {}


def _proc_init(program: Program, model_flops: float,
               host_s: Optional[float]) -> None:
    _proc_state["program"] = program
    _proc_state["plan"] = engine.prepare(program)
    _proc_state["model_flops"] = model_flops
    _proc_state["host_s"] = host_s


def _proc_run(config: EngineConfig) -> EngineResult:
    return engine.run(_proc_state["program"], config,
                      model_flops=_proc_state["model_flops"],
                      host_s=_proc_state["host_s"],
                      plan=_proc_state["plan"])


def sweep(program: Program, configs: Sequence[EngineConfig], *,
          model_flops: float = 0.0, host_s: Optional[float] = None,
          executor: str = "auto", max_workers: Optional[int] = None
          ) -> List[EngineResult]:
    """Run ``program`` under every config; one ``EngineResult`` per config.

    ``executor``:
      ``"serial"``   one process, shared ``Plan`` (default choice of auto —
                     the O(E log E) engine makes fan-out overhead the
                     bottleneck for all but the largest grids);
      ``"thread"``   ``ThreadPoolExecutor`` (the engine is pure — no shared
                     mutable state — so threads are safe);
      ``"process"``  ``ProcessPoolExecutor`` on spawned workers (safe in a
                     process that holds threads or a CUDA context); the
                     program is shipped once per worker, configs are the
                     only per-task payload.  Falls back to serial if the
                     platform refuses a pool;
      ``"auto"``     serial for small grids and chain programs, processes
                     for large DAG grids.

    Results are bit-identical across executors (each run is independent).
    """
    configs = list(configs)
    if not configs:
        return []
    plan = engine.prepare(program)
    if executor == "auto":
        big = len(program.ops) * len(configs) >= 400_000
        executor = "process" if (big and not plan.is_chain
                                 and len(configs) > 1) else "serial"
    if executor == "serial":
        return [engine.run(program, cfg, model_flops=model_flops,
                           host_s=host_s, plan=plan) for cfg in configs]
    if executor == "thread":
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=max_workers) as ex:
            return list(ex.map(
                lambda cfg: engine.run(program, cfg,
                                       model_flops=model_flops,
                                       host_s=host_s, plan=plan),
                configs))
    if executor == "process":
        import concurrent.futures
        import multiprocessing
        import os
        from concurrent.futures.process import BrokenProcessPool
        nw = max_workers or min(len(configs), os.cpu_count() or 1)
        try:
            with concurrent.futures.ProcessPoolExecutor(
                    max_workers=nw,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_proc_init,
                    initargs=(program, model_flops, host_s)) as ex:
                return list(ex.map(_proc_run, configs))
        except (BrokenProcessPool, OSError, ImportError,
                NotImplementedError):
            # pool-creation / platform failures only (sandboxed hosts, a
            # worker that died before running a task): degrade to the
            # serial path — results are identical, only wall-clock
            # differs.  A genuine error raised by engine.run inside a
            # worker is NOT swallowed: it propagates out of ex.map with
            # its own type.
            return [engine.run(program, cfg, model_flops=model_flops,
                               host_s=host_s, plan=plan) for cfg in configs]
    raise ValueError(f"unknown executor {executor!r}; "
                     "one of serial|thread|process|auto")


# ---------------------------------------------------------------------------
# analytic DSE layer: vectorized grid pricing + gradient-based search,
# with the exact event engine as the verifier of record


def _check_batchable(configs: Sequence[EngineConfig]) -> None:
    """The analytic batch varies only the continuous ``hw.PARAM_FIELDS``;
    every categorical/static knob must agree across the grid."""
    base = configs[0]
    for c in configs:
        if c.topology is not None:
            raise Unsupported(
                "batched() takes flat configs (topology=None); price "
                "explicit topologies with sweep()/topology_sweep()")
        if (c.interface != base.interface or c.overlap != base.overlap
                or c.energy != base.energy
                or type(c.energy) is not type(base.energy)
                or c.vmem_resident_bytes != base.vmem_resident_bytes
                or c.dma_transfer_bytes != base.dma_transfer_bytes
                or c.cost_backend != base.cost_backend):
            raise Unsupported(
                "batched() grids vary only the continuous PARAM_FIELDS; "
                "interface/energy/backend/tile statics must agree across "
                "configs (split the grid per interface instead)")


@dataclasses.dataclass
class BatchedSweep:
    """A grid priced by the analytic model, with exact spot checks.

    ``makespans`` is exact when ``exact`` — chain programs priced by the
    analytic model (bit-identical to ``engine.run`` on numpy), and
    fusion-resolvable DAGs priced by the engine itself over the whole
    grid — else the certified lower bound; ``lower <= exact <= upper``
    always.  ``verified`` holds the exact-engine cross-checks of the
    analytically best ``top_k`` points."""
    program: Program
    configs: List[EngineConfig]
    makespans: np.ndarray
    lower: np.ndarray
    upper: np.ndarray
    is_chain: bool
    backend: str
    verified: List[Dict]
    exact: bool = False

    def top(self, k: int = 1) -> List[int]:
        """Indices of the k analytically-fastest configs (stable order)."""
        return [int(i) for i in
                np.argsort(self.makespans, kind="stable")[:k]]

    def best(self) -> Dict:
        """The exact-engine-verified winner (first verified entry)."""
        if not self.verified:
            raise ValueError("batched() ran with top_k=0; no verified "
                             "winner to return")
        return self.verified[0]

    def records(self) -> List[Dict]:
        """Tidy per-config rows (exact columns filled for verified
        points, None elsewhere)."""
        by_idx = {v["index"]: v for v in self.verified}
        rows = []
        for i, c in enumerate(self.configs):
            v = by_idx.get(i)
            rows.append({
                "index": i, "program": self.program.name,
                "interface": c.interface, "n_workers": c.n_workers,
                **{f: float(getattr(c, f)) for f in PARAM_FIELDS},
                "analytic_s": float(self.makespans[i]),
                "lower_s": float(self.lower[i]),
                "upper_s": float(self.upper[i]),
                "exact_s": (None if v is None else v["exact_s"]),
                "relaxation_err": (None if v is None
                                   else v["relaxation_err"]),
            })
        return rows


def batched(program: Program, configs: Sequence[EngineConfig], *,
            top_k: int = 3, backend: str = "numpy", device=None,
            model_flops: float = 0.0, host_s: Optional[float] = None
            ) -> BatchedSweep:
    """Price a whole config grid through the analytic cost model at once.

    One (B, 14) ``hw.PARAM_FIELDS`` matrix evaluates vectorized —
    thousands of design points per second instead of one engine run per
    config — then the analytically best ``top_k`` points are re-run
    through the exact engine (``verified``), so the winner you act on is
    never an artifact of the relaxation.  Chain programs price exactly:
    on the default numpy backend the values are **bit-identical** to
    ``engine.run`` (``backend="torch"``/``"auto"`` trade that for float64
    torch on ``device``, allclose only); DAGs get the certified
    lower/upper bracket.  Raises ``costmodel.Unsupported`` for grids the
    model can't mirror (heterogeneous topologies, custom
    interfaces/energy models) — ``sweep()`` remains the universal path.

    DAG programs that linear-run fusion collapses to a small segment
    graph (``engine.fusion_resolvable``) skip the relaxation entirely:
    the fused engine prices every grid point exactly over one shared
    compiled plan, so ``lower == upper == makespans`` and every verified
    row reports ``relaxation_err == 0``.
    """
    configs = list(configs)
    if not configs:
        return BatchedSweep(program=program, configs=[],
                            makespans=np.zeros(0), lower=np.zeros(0),
                            upper=np.zeros(0), is_chain=True,
                            backend="numpy", verified=[], exact=True)
    _check_batchable(configs)
    plan = engine.prepare(program)
    if not plan.is_chain and engine.fusion_resolvable(plan):
        # exact DAG pricing: fusion resolved the program to a segment
        # graph small enough that the event engine beats the relaxation
        # at its own game — run the whole grid on one compiled plan.
        results = [engine.run(program, c, model_flops=model_flops,
                              host_s=host_s, plan=plan) for c in configs]
        mk = np.array([r.makespan for r in results])
        verified: List[Dict] = []
        if top_k > 0:
            for i in np.argsort(mk, kind="stable")[:top_k]:
                i = int(i)
                verified.append({
                    "index": i, "config": configs[i],
                    "result": results[i], "analytic_s": float(mk[i]),
                    "exact_s": results[i].makespan,
                    "relaxation_err": 0.0})
            verified.sort(key=lambda v: v["exact_s"])
        return BatchedSweep(program=program, configs=configs,
                            makespans=mk, lower=mk, upper=mk,
                            is_chain=False, backend="engine",
                            verified=verified, exact=True)
    model = CostModel(program, configs[0], backend=backend, device=device)
    P = np.array([hw.params_from_config(c) for c in configs])
    nw = np.array([float(c.n_workers) for c in configs])
    lower, upper = model.bounds(P, n_workers=nw)
    verified: List[Dict] = []
    if top_k > 0:
        for i in np.argsort(lower, kind="stable")[:top_k]:
            i = int(i)
            res = engine.run(program, configs[i], model_flops=model_flops,
                             host_s=host_s, plan=plan)
            err = ((float(lower[i]) - res.makespan) / res.makespan
                   if res.makespan else 0.0)
            verified.append({
                "index": i, "config": configs[i], "result": res,
                "analytic_s": float(lower[i]), "exact_s": res.makespan,
                "relaxation_err": err})
        verified.sort(key=lambda v: v["exact_s"])
    return BatchedSweep(program=program, configs=configs,
                        makespans=lower, lower=lower, upper=upper,
                        is_chain=model.is_chain, backend=model.backend,
                        verified=verified, exact=model.is_chain)


@dataclasses.dataclass
class OptimizeResult:
    """An exact-engine-verified design point from ``optimize()``."""
    config: EngineConfig
    params: Dict[str, float]      # the optimized space fields
    exact_s: float                # engine.run makespan at the design
    analytic_s: float             # the model's value at the same point
    relaxation_err: float
    objective: float              # exact-makespan objective value
    feasible: Optional[bool]      # exact_s <= target_s (None: no target)
    target_s: Optional[float]
    backend: str                  # gradient backend actually used
    n_evals: int                  # analytic design points priced
    result: EngineResult
    candidates: List[Dict]        # every exact-verified finalist


def optimize(program: Program, space: Dict[str, Tuple[float, float]], *,
             base_config: Optional[EngineConfig] = None,
             target_s: Optional[float] = None,
             cost: Optional[Callable] = None,
             n_starts: int = 8, steps: int = 60, lr: float = 0.25,
             seed: int = 0, verify_k: int = 4, backend: str = "auto",
             device=None, model_flops: float = 0.0,
             host_s: Optional[float] = None) -> OptimizeResult:
    """Gradient-based design-space search over continuous hardware knobs.

    ``space`` maps ``hw.PARAM_FIELDS`` names to (lo, hi) ranges.  The
    search runs multi-start projected gradient descent on the analytic
    cost model in normalized z-space (geometric interpolation per
    range): with the torch backend the gradients are analytic
    (``torch.func`` vmap+grad of the same term functions the engine runs,
    on ``device``: the card unless ``device="cpu"``), on numpy they are
    batched central differences — either way every step prices its whole
    stencil in one vectorized call.  ``backend="auto"`` is torch on chains
    and numpy on DAGs.  Without ``target_s`` the objective is the
    makespan; with it, "the cheapest design meeting the latency target"
    (``cost`` defaults to mean normalized size; a callable receives the
    (B, 14) parameter matrix).  The ``verify_k`` best candidates are re-run
    through the exact event engine and the returned design is chosen on
    EXACT numbers, so the relaxation can steer but never lie.
    """
    model = CostModel(program, base_config, backend=backend, device=device)
    if model.base.topology is not None:
        raise Unsupported(
            "optimize() searches flat configs (topology=None); express "
            "the SoC as flat fields, or grid explicit topologies through "
            "sweep()")
    obj = model.objective(space, target_s=target_s, cost=cost)
    d = len(obj.names)
    rng = np.random.default_rng(seed)
    S = max(int(n_starts), 1)
    Z = rng.uniform(size=(S, d))
    # deterministic anchor starts: center, max-hardware and min-hardware
    # corners (the pure-latency optimum usually lives near a corner)
    for i, z0 in enumerate((0.5, 1.0, 0.0)):
        if i < S:
            Z[i] = z0
    best_z = Z.copy()
    best_v = np.full(S, np.inf)
    lr_t = lr
    n_evals = 0
    for _ in range(int(steps)):
        v = obj.value(Z)
        n_evals += S
        better = v < best_v
        best_v = np.where(better, v, best_v)
        best_z[better] = Z[better]
        g = obj.grad(Z)
        n_evals += S * (2 * d if obj.backend == "numpy" else 1)
        gn = np.max(np.abs(g), axis=1, keepdims=True)
        Z = np.clip(Z - lr_t * (g / np.maximum(gn, 1e-12)), 0.0, 1.0)
        lr_t *= 0.97
    v = obj.value(Z)
    n_evals += S
    better = v < best_v
    best_v = np.where(better, v, best_v)
    best_z[better] = Z[better]

    # rank the per-start winners, dedupe, exact-verify the finalists
    order = np.argsort(best_v, kind="stable")
    seen = set()
    finalists: List[np.ndarray] = []
    for i in order:
        key = tuple(np.round(best_z[i], 5))
        if key in seen:
            continue
        seen.add(key)
        finalists.append(best_z[i])
        if len(finalists) >= max(int(verify_k), 1):
            break
    plan = engine.prepare(program)
    candidates: List[Dict] = []

    def _verify(z) -> Dict:
        P = obj.to_params(z[None, :])
        analytic = float(model.makespans(P)[0])
        params = {nm: float(P[0, di])
                  for nm, di in zip(obj.names, obj.dims)}
        cfg = model.config_for(params)
        res = engine.run(program, cfg, model_flops=model_flops,
                         host_s=host_s, plan=plan)
        exact = res.makespan
        if target_s is None:
            exact_obj = exact
            feasible = None
        else:
            c = (cost(P)[0] if cost is not None
                 else float(np.mean(z)))
            feasible = bool(exact <= target_s * (1.0 + 1e-12))
            exact_obj = float(c) + (0.0 if feasible else
                                    100.0 * (exact / target_s - 1.0) ** 2)
        return {"params": params, "config": cfg, "result": res,
                "exact_s": exact, "analytic_s": analytic,
                "relaxation_err": ((analytic - exact) / exact
                                   if exact else 0.0),
                "objective": float(exact_obj), "feasible": feasible}

    for z in finalists:
        candidates.append(_verify(z))
    if target_s is not None and not any(c["feasible"] for c in candidates):
        # every finalist sits just over the target (the descent converges
        # onto the feasibility boundary, and the exact engine may price
        # the boundary a hair above the relaxation).  Back the best one
        # off toward the max-hardware corner until the exact engine
        # confirms feasibility — t=1 is the corner itself, so a reachable
        # target always yields a feasible candidate.
        zb = finalists[int(np.argmin([c["objective"]
                                      for c in candidates]))]
        for t in (0.02, 0.05, 0.1, 0.2, 0.4, 1.0):
            cand = _verify(zb + t * (1.0 - zb))
            if cand["feasible"]:
                candidates.append(cand)
                break
    # exact numbers pick the winner; with a target, feasible designs
    # outrank infeasible ones outright
    candidates.sort(key=lambda c: (not c["feasible"]
                                   if c["feasible"] is not None else False,
                                   c["objective"]))
    win = candidates[0]
    return OptimizeResult(
        config=win["config"], params=win["params"],
        exact_s=win["exact_s"], analytic_s=win["analytic_s"],
        relaxation_err=win["relaxation_err"],
        objective=win["objective"], feasible=win["feasible"],
        target_s=target_s, backend=obj.backend, n_evals=n_evals,
        result=win["result"], candidates=candidates)


def topology_sweep(program: Program, topologies: Sequence[SoCTopology],
                   base_config: Optional[EngineConfig] = None,
                   **kw) -> List[EngineResult]:
    """Run ``program`` on every ``SoCTopology`` of a grid: each topology
    is installed into a copy of ``base_config`` (default: a fresh
    ``EngineConfig()``, one H100's constants) and the grid goes through
    ``sweep`` — one lowering, one shared plan, one ``EngineResult`` per
    SoC.  The SMAUG SoC-tuning studies (how many accelerators, which
    frontend device, how many shared ports) are one call."""
    base = base_config if base_config is not None else EngineConfig()
    configs = [dataclasses.replace(base, topology=t) for t in topologies]
    return sweep(program, configs, **kw)


def training_sweep(cfg, *, schedules: Sequence[str] = ("gpipe", "1f1b"),
                   n_stages_grid: Sequence[int] = (1, 2, 4),
                   n_microbatches_grid: Sequence[int] = (1, 4, 8),
                   seq_len: int = 512, global_batch: Optional[int] = None,
                   base_config: Optional[EngineConfig] = None,
                   **kw) -> List:
    """Run the pipeline-parallel design-space grid: one
    ``repro_torch.sim.training.TrainingResult`` per (n_stages, n_microbatches,
    schedule) cell, in that nesting order.  Every cell simulates the SAME
    amount of work — ``global_batch`` defaults to the least common
    multiple of ``n_microbatches_grid`` so every microbatch count divides
    it; a caller-supplied value must divide by every entry.  Extra keyword
    arguments pass through to ``simulate_training``."""
    import math

    from repro_torch.sim.training import simulate_training
    base = base_config if base_config is not None else EngineConfig()
    if global_batch is None:
        global_batch = math.lcm(*n_microbatches_grid)
    out = []
    for p in n_stages_grid:
        for m in n_microbatches_grid:
            for schedule in schedules:
                res = simulate_training(
                    cfg, n_stages=p, n_microbatches=m, schedule=schedule,
                    seq_len=seq_len, global_batch=global_batch,
                    config=base, **kw)
                res.meta.update({"model": getattr(cfg, "name", "model")})
                out.append(res)
    return out


def fleet_sweep(cfg, *, routers: Sequence[str] = ("round_robin",
                                                  "least_outstanding",
                                                  "session_affinity"),
                replica_counts: Sequence[int] = (1, 2, 4),
                policy=None, n_requests: int = 2000,
                rate_rps: float = 200.0, trace_kind: str = "diurnal",
                seed: int = 0, config: Optional[EngineConfig] = None,
                bytes_per_param: float = 2.0, **trace_kw) -> List:
    """Run the router x replica-count fleet grid: one
    ``repro_torch.sim.serving.FleetResult`` per (router, n_replicas) cell,
    in that nesting order.  Every cell replays the SAME seeded trace (one
    generator call, shared across cells) through ONE shared
    ``StepCostTable``, so the comparison isolates the routing/replica
    choice and the whole grid prices steps out of a single memo."""
    from repro_torch.serve.policy import get_policy
    from repro_torch.sim.serving import (TRACE_GENERATORS, StepCostTable,
                                         simulate_fleet)
    base = config if config is not None else EngineConfig()
    if policy is None:
        policy = get_policy("continuous", max_batch=8)
    trace = TRACE_GENERATORS[trace_kind](
        n_requests, rate_rps, seed=seed, arrays=True, **trace_kw) \
        if trace_kind == "diurnal" else \
        TRACE_GENERATORS[trace_kind](n_requests, rate_rps, seed=seed,
                                     **trace_kw)
    table = StepCostTable(cfg, base, bytes_per_param=bytes_per_param)
    out = []
    for router in routers:
        for n in replica_counts:
            res = simulate_fleet(cfg, trace, policy, base,
                                 n_replicas=n, router=router,
                                 bytes_per_param=bytes_per_param,
                                 table=table)
            res.meta.update({"model": getattr(cfg, "name", "model"),
                             "router": router, "n_replicas": n,
                             "rate_rps": rate_rps,
                             "trace_kind": trace_kind, "seed": seed})
            out.append(res)
    return out


def placements_for(n_accel: int, *, max_tp: int = 8,
                   max_pp: int = 8) -> List[Tuple[int, int, int]]:
    """All ``(dp, pp, tp)`` placements with ``dp * pp * tp == n_accel``,
    TP and PP restricted to powers of two up to their caps (the shapes
    real launch configs use: TP within a node, PP across a handful of
    stages, DP soaking up the rest)."""
    out = []
    tp = 1
    while tp <= min(max_tp, n_accel):
        pp = 1
        while tp * pp <= n_accel and pp <= max_pp:
            if n_accel % (tp * pp) == 0:
                out.append((n_accel // (tp * pp), pp, tp))
            pp *= 2
        tp *= 2
    return out


def cluster_sweep(cfg, *, n_accel_grid: Sequence[int] = (8, 64, 512),
                  algos: Sequence[str] = ("ring", "tree", "hierarchical"),
                  placements: Optional[Sequence[Tuple[int, int, int]]]
                  = None,
                  seq_len: int = 512, global_batch: int = 32,
                  schedule: str = "1f1b",
                  base_config: Optional[EngineConfig] = None,
                  accels_per_chip: int = 4, chips_per_node: int = 8,
                  max_tp: int = 8, max_pp: int = 8, **kw) -> List:
    """Run the cluster design-space grid: one ``TrainingResult`` per
    (n_accel, (dp, pp, tp), collective_algo) cell over a
    ``hw.Fabric.cluster`` of each size — the "cheapest N-accelerator
    config that trains the model under a step-time target" question is
    ``min`` over ``as_cluster_records`` rows filtered on ``step_time_s``.

    ``global_batch`` is the CLUSTER batch: each DP replica simulates
    ``global_batch / dp`` sequences (floored at one sequence per
    microbatch), with ``n_microbatches = min(2 * pp, 16)`` so deeper
    pipes get enough microbatches to fill.  Extra kwargs pass through to
    ``simulate_training``."""
    from repro_torch.sim.training import simulate_training
    base = base_config if base_config is not None else EngineConfig()
    out = []
    for n in n_accel_grid:
        fab = hw.Fabric.cluster(n, accels_per_chip=accels_per_chip,
                                chips_per_node=chips_per_node)
        cells = (placements if placements is not None
                 else placements_for(n, max_tp=max_tp, max_pp=max_pp))
        for dp, pp, tp in cells:
            if dp * pp * tp != n:
                continue
            m = min(2 * pp, 16)
            replica_batch = m * max(1, round(global_batch / (dp * m)))
            for algo in algos:
                res = simulate_training(
                    cfg, n_stages=pp, n_microbatches=m,
                    schedule=schedule, seq_len=seq_len,
                    global_batch=replica_batch, config=base,
                    dp_degree=dp, tp_degree=tp, fabric=fab,
                    collective_algo=algo, **kw)
                res.meta.update({"model": getattr(cfg, "name", "model"),
                                 "cluster_global_batch": global_batch})
                out.append(res)
    return out


def as_cluster_records(results: Iterable) -> List[Dict[str, float]]:
    """Flatten cluster ``TrainingResult``s to tidy rows with the
    placement axes, whole-cluster throughput/energy, and per-step TCO
    (``hw.tco_per_step``: amortized accelerator capex + energy)."""
    rows = []
    for r in results:
        dp = int(r.meta.get("dp_degree", 1))
        tp = int(r.meta.get("tp_degree", 1))
        n_accel = int(r.meta.get("n_accel", dp * tp * r.n_stages))
        replica_j = r.engine.energy["total_j"]
        cluster_j = replica_j * dp * tp
        cluster_tokens = r.tokens * dp
        tco = hw.tco_per_step(n_accel, r.step_time_s, cluster_j)
        rows.append({
            "program": r.program.name,
            "model": r.meta.get("model", ""),
            "n_accel": n_accel,
            "dp_degree": dp, "pp_degree": r.n_stages, "tp_degree": tp,
            "collective_algo": r.meta.get("collective_algo", "ring"),
            "fabric": r.meta.get("fabric"),
            "schedule": r.schedule,
            "n_microbatches": r.n_microbatches,
            "replica_batch": r.meta.get("global_batch"),
            "seq_len": r.meta.get("seq_len"),
            "bound": r.engine.roofline.bound,
            "cluster_tokens_per_s": (cluster_tokens / r.step_time_s
                                     if r.step_time_s else 0.0),
            "replica_j": replica_j, "cluster_j": cluster_j,
            "tco_usd_per_step": tco,
            "tco_usd_per_mtok": (tco / (cluster_tokens / 1e6)
                                 if cluster_tokens else 0.0),
            **r.stats(),
        })
    return rows


def as_training_records(results: Iterable) -> List[Dict[str, float]]:
    """Flatten ``TrainingResult``s to tidy per-cell dicts (the training
    analogue of ``as_records``)."""
    rows = []
    for r in results:
        rows.append({
            "program": r.program.name,
            "model": r.meta.get("model", ""),
            "schedule": r.schedule,
            "n_stages": r.n_stages,
            "n_microbatches": r.n_microbatches,
            "seq_len": r.meta.get("seq_len"),
            "global_batch": r.meta.get("global_batch"),
            "interface": r.config.interface,
            "bound": r.engine.roofline.bound,
            "total_j": r.engine.energy["total_j"],
            **r.stats(),
        })
    return rows


def as_records(results: Iterable[EngineResult]) -> List[Dict[str, float]]:
    """Flatten results to tidy per-config dicts (DataFrame-friendly)."""
    rows = []
    for r in results:
        c = r.config
        topo = c.resolved_topology()
        rows.append({
            "program": r.program.name, "n_ops": len(r.program.ops),
            "interface": c.interface, "n_workers": c.n_workers,
            "topology": topo.name if c.topology is not None else "flat",
            "devices": topo.describe(), "n_accel": topo.n_accel,
            "hbm_ports": c.hbm_ports, "host_threads": c.host_threads,
            "datapath_scale": c.datapath_scale,
            "peak_flops": c.peak_flops,
            "makespan_s": r.makespan,
            "accelerator_s": r.breakdown.accelerator_s,
            "transfer_s": r.breakdown.transfer_s,
            "host_s": r.breakdown.host_s,
            "collective_s": r.breakdown.collective_s,
            "step_s": r.roofline.step_s, "bound": r.roofline.bound,
            "total_j": r.energy["total_j"],
            "utilization": r.utilization(),
            # analytic-model fidelity for free: 0.0 on chains (the model
            # IS the fast path), <= 0 lower-bound error on DAGs, None
            # where no analytic model exists (heterogeneous SoCs, custom
            # interfaces/energy models)
            "relaxation_err": costmodel.relaxation_err(r),
        })
    return rows
