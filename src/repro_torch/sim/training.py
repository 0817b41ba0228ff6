"""Pipeline-parallel training simulation: schedules, stages, the engine.

SMAUG's argument — end-to-end behavior is dominated by what happens
*around* the accelerator — applies with full force to distributed
training: the pipeline *schedule* (when each stage runs which microbatch)
and the inter-stage activation/gradient transfers decide step time as much
as per-stage kernel speed does.  This module opens that workload class on
the existing event engine: a training step (``ir.from_training_step``) is
split over ``n_stages`` pipeline stages, each stage pinned to one device
of an ``SoCTopology``, and the per-(stage, microbatch) forward /
backward work items are serialized per device in the exact order of a
classic pipeline schedule:

  ``gpipe``  all M forwards, then all M backwards (the flush schedule:
             largest bubble, simplest memory profile);
  ``1f1b``   the Megatron one-forward-one-backward order: stage ``s``
             warms up with ``min(S-1-s, M)`` forwards, then alternates
             F/B in steady state, then drains the remaining backwards —
             same bubble bound as GPipe on homogeneous stages, and never
             slower on an *uncontended* homogeneous pipe.  On a
             port-constrained shared link (or a congested serial host
             lane) 1F1B keeps both pipeline directions in flight at
             once — roughly double GPipe's concurrent demand — and can
             genuinely lose to the flush schedule (the contended grid of
             ``chip_smoke.py``'s training study shows where).

How the co-simulation works.  The schedule is *encoded in the program*:
every op depends on its predecessor in its device's schedule order (the
serialization edge) in addition to its dataflow deps (``F(s,m)`` needs the
activation transfer from stage ``s-1``; ``B(s,m)`` needs ``F(s,m)``'s
stored activations and the gradient transfer from stage ``s+1``).  Any
topological execution of that DAG yields the same timing, so the engine's
event loop — with per-device placement via per-stage ``device_class``
tags, per-link transfer contention, the host model and the ICI lane —
prices the schedule exactly.  Inter-stage boundary tensors
(``d_model * microbatch_tokens * bytes_per_act``) are explicit transfer
ops placed on the *receiving* stage, so they contend on that device's
link like any other traffic.

``TrainingResult`` reports the step time, per-stage utilization, and the
measured pipeline bubble fraction next to the analytic homogeneous bound
``(p-1)/(m+p-1)`` (equal ideal per-microbatch cost, free transfers).  A
1-stage 1-microbatch simulation is bit-identical to running the flat
``ir.from_training_step`` chain through ``engine.run``, and the whole
layer is deterministic: same config, same result, bit for bit.

The port's copy of ``repro/sim/training.py``, held ``==`` to it at the TPU
v5e constants passed explicitly by ``tests/test_torch_training.py`` and
``tests/test_torch_cluster.py``.  numpy only: importing it loads no torch.
A bare ``EngineConfig()`` is one H100 at the float32 peak of its CUDA
cores; a bf16 model's step is priced at its bf16 peak by passing
``repro_torch.apps.serving.default_config()``, as
``repro_torch.launch.train.dry_run`` does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.sim import engine, ir
from repro_torch.sim.engine import EngineConfig, EngineResult
from repro_torch.sim.hw import Device, Link, SoCTopology
from repro_torch.sim.ir import CostedOp, Program, partition_stages

__all__ = ["TrainingResult", "SCHEDULES", "bubble_bound",
           "simulate_training", "schedule_order", "partition_stages"]

SCHEDULES = ("gpipe", "1f1b")


def bubble_bound(n_stages: int, n_microbatches: int) -> float:
    """The analytic pipeline bubble fraction ``(p-1)/(m+p-1)`` for
    homogeneous stages with equal per-microbatch cost and free
    transfers — both GPipe and 1F1B meet it exactly in that regime."""
    return (n_stages - 1) / float(n_microbatches + n_stages - 1)


def schedule_order(schedule: str, stage: int, n_stages: int,
                   n_microbatches: int) -> List[Tuple[str, int]]:
    """The work-item order of one stage under a schedule: a list of
    ``("F"|"B", microbatch)`` covering every microbatch exactly once in
    each direction.  This IS the per-device serialization order the
    simulator encodes as dependency edges."""
    m = n_microbatches
    if schedule == "gpipe":
        return [("F", i) for i in range(m)] + [("B", i) for i in range(m)]
    if schedule == "1f1b":
        nw = min(n_stages - 1 - stage, m)
        order = [("F", i) for i in range(nw)]
        for i in range(m - nw):
            order.append(("F", nw + i))
            order.append(("B", i))
        order.extend(("B", i) for i in range(m - nw, m))
        return order
    raise ValueError(f"unknown schedule {schedule!r}; one of {SCHEDULES}")


@dataclass
class TrainingResult:
    """Everything one simulated training step produced.

    ``engine`` is the ordinary ``EngineResult`` of the scheduled step
    program; ``step_time_s`` is its makespan (reduce + optimizer update
    included).  ``bubble_fraction`` is measured over the *pipeline body*
    (first forward start to last backward end, forward/backward compute
    only — transfers, reduce and update excluded), so on homogeneous
    stages with an ideal interface it equals ``bubble_bound`` to float
    precision."""
    program: Program
    engine: EngineResult
    schedule: str
    n_stages: int
    n_microbatches: int
    step_time_s: float
    tokens: float
    per_stage_busy_s: Dict[str, float]
    per_stage_utilization: Dict[str, float]
    bubble_fraction: float
    bubble_bound: float
    config: EngineConfig
    meta: Dict = field(default_factory=dict)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.step_time_s if self.step_time_s else 0.0

    def stats(self) -> Dict[str, float]:
        """Tidy scalar summary (the ``as_training_records`` row body)."""
        utils = list(self.per_stage_utilization.values())
        return {
            "step_time_s": self.step_time_s,
            "tokens_per_s": self.tokens_per_s,
            "bubble_fraction": self.bubble_fraction,
            "bubble_bound": self.bubble_bound,
            "bubble_excess": self.bubble_fraction - self.bubble_bound,
            "stage_util_mean": sum(utils) / len(utils) if utils else 0.0,
            "stage_util_min": min(utils) if utils else 0.0,
            "collective_s": self.engine.breakdown.collective_s,
            "n_ops": float(len(self.program.ops)),
        }


def _stage_topology(config: EngineConfig, n_stages: int
                    ) -> Tuple[SoCTopology, Tuple[str, ...]]:
    """(topology with per-stage placement kinds, stage device names).

    ``config.topology`` set: its accelerator-class devices, in declaration
    order, become the stages (kinds rewritten to ``stage<s>``; per-device
    overrides — a slower stage, a different link — are preserved, which is
    exactly how heterogeneous-stage studies are set up).  A topology with
    NO accelerator-class devices follows the engine's placement-fallback
    convention (class -> accel -> any): every device is stage-capable, so
    training on an all-cpu/dsp SoC runs on those devices at their own
    cost parameters.  Unset: the homogeneous expansion — ``n_stages``
    identical stage devices on one shared link inheriting every flat
    field.
    """
    if config.topology is not None:
        topo = config.topology
        accel = [i for i, d in enumerate(topo.devices) if d.kind == "accel"]
        if not accel:
            accel = list(range(len(topo.devices)))
        if len(accel) < n_stages:
            raise ValueError(
                f"topology {topo.name!r} has {len(accel)} stage-capable "
                f"devices but the schedule needs {n_stages}")
        chosen = accel[:n_stages]
        devices = list(topo.devices)
        names = []
        for s, i in enumerate(chosen):
            devices[i] = dataclasses.replace(devices[i], kind=f"stage{s}")
            names.append(devices[i].name)
        return (SoCTopology(devices=tuple(devices), links=topo.links,
                            name=topo.name), tuple(names))
    devices = tuple(Device(f"stage{s}", kind=f"stage{s}")
                    for s in range(n_stages))
    return (SoCTopology(devices=devices, links=(Link("hbm"),),
                        name=f"{n_stages}stage"),
            tuple(d.name for d in devices))


def simulate_training(cfg, *, n_stages: int = 1, n_microbatches: int = 1,
                      schedule: str = "1f1b", seq_len: int = 512,
                      global_batch: int = 8,
                      config: Optional[EngineConfig] = None,
                      bytes_per_param: float = 2.0,
                      bytes_per_act: float = 2.0,
                      dp_degree: int = 1, tp_degree: int = 1,
                      fabric=None, collective_algo: str = "ring",
                      name: str = "") -> TrainingResult:
    """Simulate one pipeline-parallel training step; see the module header.

    ``cfg`` is a ``repro_torch.core.config.ModelConfig``; ``config``
    defaults to a fresh flat ``EngineConfig()`` (``None`` sentinel): one
    H100 at its float32 peak.
    ``n_microbatches`` must divide ``global_batch`` evenly (every
    microbatch carries the same sequences).  With ``n_stages == 1``
    and no topology the program runs on the flat config unchanged, so the
    single-stage single-microbatch case is the plain
    ``ir.from_training_step`` chain.

    **Cluster placement** (``fabric`` given): one global rank per
    accelerator, ``rank(d, s, t) = (d * n_stages + s) * tp_degree + t``
    (TP fastest-varying, so TP groups sit on the innermost fabric tiers).
    DP-rank 0's pipeline is simulated; the collectives it participates in
    are lowered to explicit per-hop fabric transfers
    (``ir.from_collective``): TP all-reduces after every forward/backward
    (per stage, per microbatch, on the stage's TP-group lane), pipeline
    boundary tensors as hops on the tier the adjacent stages span, and
    the per-stage DP gradient all-reduce with ``collective_algo`` — which
    starts as soon as THAT stage's last backward retires, so late stages'
    gradient reduction genuinely overlaps earlier stages' backwards.
    """
    if config is None:
        config = EngineConfig()
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"one of {SCHEDULES}")
    n_stages = int(n_stages)
    n_microbatches = int(n_microbatches)
    tp_degree = int(tp_degree)
    dp_degree = int(dp_degree)
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, "
                         f"got {n_microbatches}")
    if global_batch % n_microbatches:
        raise ValueError(
            f"global_batch {global_batch} is not divisible by "
            f"n_microbatches {n_microbatches}")
    mb_batch = global_batch // n_microbatches
    if tp_degree > 1 and fabric is None:
        raise ValueError("tp_degree > 1 requires a fabric")
    n_accel = dp_degree * n_stages * tp_degree
    if fabric is not None and fabric.n_accel < n_accel:
        raise ValueError(
            f"fabric {fabric.describe()} has {fabric.n_accel} "
            f"accelerators; placement dp{dp_degree} x pp{n_stages} x "
            f"tp{tp_degree} needs {n_accel}")

    pinned = n_stages > 1 or config.topology is not None
    if pinned:
        topo, stage_devs = _stage_topology(config, n_stages)
        run_config = dataclasses.replace(config, topology=topo)
    else:
        topo, stage_devs = None, ("",)
        run_config = config
    if fabric is not None and config.fabric is None:
        # per-tier rate overrides on the Fabric resolve through the config
        run_config = dataclasses.replace(run_config, fabric=fabric)

    # placement: global rank of (dp, stage, tp) under the rank convention
    def tp_members(s: int) -> Tuple[int, ...]:
        base = s * tp_degree                  # dp rank 0
        return tuple(base + t for t in range(tp_degree))

    def dp_members(s: int) -> Tuple[int, ...]:
        return tuple((d * n_stages + s) * tp_degree
                     for d in range(dp_degree))

    # per-stage cost templates: ir.from_training_step is the single source
    # of cost truth (fwd/bwd per microbatch; reduce/update once per stage)
    templates = [ir.from_training_step(
        cfg, seq_len=seq_len, batch=mb_batch,
        stage=(s if n_stages > 1 else None), n_stages=n_stages,
        bytes_per_param=bytes_per_param, bytes_per_act=bytes_per_act,
        dp_degree=dp_degree, tp_degree=tp_degree, fabric=fabric,
        collective_algo=collective_algo,
        tp_group=tp_members(s) if fabric is not None else None,
        dp_group=dp_members(s) if fabric is not None else None)
        for s in range(n_stages)]
    by_name = [{op.name: op for op in t.ops} for t in templates]

    # hop segments of each template (empty without a fabric): the TP
    # all-reduce after fwd/bwd and the per-stage DP gradient reduce
    def _segment(t: Program, prefix: str):
        sel = [op for op in t.ops if op.name.startswith(prefix)]
        names = {o.name for o in sel}
        # internal deps precomputed once: per clone only the rename varies
        pre = [(o, tuple(d for d in o.deps if d in names)) for o in sel]
        return pre, (ir._sinks(sel) if sel else ())

    tpf_seg = [_segment(t, "train/tpf") for t in templates]
    tpb_seg = [_segment(t, "train/tpb") for t in templates]
    dp_seg = [_segment(t, "train/dp") for t in templates]

    def f_out(s: int, m: int) -> Tuple[str, ...]:
        """Names the stage-s microbatch-m forward RESULT waits on (the
        TP all-reduce sinks when TP is on, else the fwd op itself)."""
        sinks = tpf_seg[s][1]
        return (tuple(f"{n}@s{s}m{m}" for n in sinks)
                or (f"F/s{s}/m{m}",))

    def b_out(s: int, m: int) -> Tuple[str, ...]:
        sinks = tpb_seg[s][1]
        return (tuple(f"{n}@s{s}m{m}" for n in sinks)
                or (f"B/s{s}/m{m}",))

    # one residual-stream tensor crosses each stage boundary per microbatch
    boundary_bytes = (float(cfg.d_model) * mb_batch * seq_len
                      * bytes_per_act)

    def cls(s: int) -> str:
        return f"stage{s}" if pinned else "accel"

    _bh_tmpl: Dict[Tuple[int, int], CostedOp] = {}
    _new = object.__new__

    def boundary_hop(nm: str, lo: int, recv: int,
                     deps: Tuple[str, ...]) -> CostedOp:
        """The stage-(lo)<->(lo+1) boundary tensor, placed on receiving
        stage ``recv``.  Stages sharing a chip (span tier 0) keep the
        legacy device-transfer modeling — which is what makes a
        single-tier fabric bit-identical to the pre-fabric simulator;
        stages on different chips/nodes ride the fabric tier their member
        sets span.  The op is identical across microbatches except for
        name/deps, so the tier resolution is cached per stage pair."""
        tmpl = _bh_tmpl.get((lo, recv))
        if tmpl is None:
            members = tp_members(lo) + tp_members(lo + 1)
            ti = fabric.span_tier(members)
            if ti == 0:
                tmpl = CostedOp(name="", bytes_in=boundary_bytes,
                                phase=f"s{recv}", device_class=cls(recv))
            else:
                tmpl = CostedOp(name="",
                                collective_bytes=boundary_bytes,
                                wire_bytes=boundary_bytes,
                                tier=fabric.tiers[ti].name,
                                lane=fabric.lane(members, ti),
                                phase=f"s{recv}",
                                device_class=cls(recv))
            _bh_tmpl[(lo, recv)] = tmpl
        c = _new(CostedOp)
        d = c.__dict__
        d.update(tmpl.__dict__)
        d["name"] = nm
        d["deps"] = deps
        return c

    ops: List[CostedOp] = []
    ops_append = ops.append
    for s in range(n_stages):
        prev: Tuple[str, ...] = ()      # serialization edge on this device
        ph = f"s{s}"
        dc = cls(s)

        def emit(op: CostedOp) -> None:
            nonlocal prev
            deps = tuple(op.deps)
            add = tuple(p for p in prev if p not in deps)
            c = _new(CostedOp)
            d = c.__dict__
            d.update(op.__dict__)
            d["deps"] = add + deps
            ops_append(c)
            prev = (op.name,)

        def emit_t(op: CostedOp, nm: str, deps: Tuple[str, ...]) -> None:
            """emit() of a per-stage template op restamped with
            name/deps/phase/device_class — the hot clone path."""
            nonlocal prev
            add = tuple(p for p in prev if p not in deps)
            c = _new(CostedOp)
            d = c.__dict__
            d.update(op.__dict__)
            d["name"] = nm
            d["deps"] = add + deps
            d["phase"] = ph
            d["device_class"] = dc
            ops_append(c)
            prev = (nm,)

        def emit_hops(seg, tag: str, roots: Tuple[str, ...]) -> None:
            """Clone a hop segment under ``tag``: internal deps rename
            with it, the segment's roots re-root on ``roots``.  Parallel
            branches (hierarchical sub-group chains) stay parallel — only
            the segment as a whole serializes with the device's schedule
            (via ``roots``/``prev``), matching a blocking collective."""
            nonlocal prev
            seg_ops, seg_sinks = seg
            at = "@" + tag
            for o, idep in seg_ops:
                c = _new(CostedOp)
                d = c.__dict__
                d.update(o.__dict__)
                d["name"] = o.name + at
                d["deps"] = (tuple(dp + at for dp in idep) or roots)
                d["phase"] = ph
                ops_append(c)
            prev = tuple(n + at for n in seg_sinks)

        for kind, m in schedule_order(schedule, s, n_stages,
                                      n_microbatches):
            if kind == "F":
                if s > 0:               # activation arrives from stage s-1
                    if fabric is None:
                        emit(CostedOp(name=f"xF/s{s}/m{m}",
                                      bytes_in=boundary_bytes,
                                      deps=(f"F/s{s-1}/m{m}",),
                                      phase=f"s{s}", device_class=cls(s)))
                    else:
                        emit(boundary_hop(f"xF/s{s}/m{m}", s - 1, s,
                                          f_out(s - 1, m)))
                emit_t(by_name[s]["train/fwd"], f"F/s{s}/m{m}", ())
                if tpf_seg[s][0]:
                    emit_hops(tpf_seg[s], f"s{s}m{m}", prev)
            else:
                if s < n_stages - 1:    # gradient arrives from stage s+1
                    if fabric is None:
                        emit(CostedOp(name=f"xB/s{s}/m{m}",
                                      bytes_in=boundary_bytes,
                                      deps=(f"B/s{s+1}/m{m}",),
                                      phase=f"s{s}", device_class=cls(s)))
                    else:
                        emit(boundary_hop(f"xB/s{s}/m{m}", s, s,
                                          b_out(s + 1, m)))
                emit_t(by_name[s]["train/bwd"], f"B/s{s}/m{m}",
                       (f"F/s{s}/m{m}",))
                if tpb_seg[s][0]:
                    emit_hops(tpb_seg[s], f"s{s}m{m}", prev)
        if "train/reduce" in by_name[s]:
            emit_t(by_name[s]["train/reduce"], f"R/s{s}", ())
        elif dp_seg[s][0]:
            # the stage's gradient all-reduce waits only for ITS last
            # backward — late stages reduce while earlier stages are
            # still in backward (DP/bwd overlap across the pipeline)
            emit_hops(dp_seg[s], f"s{s}", prev)
        emit_t(by_name[s]["train/update"], f"U/s{s}", ())

    tokens = float(global_batch) * float(seq_len)
    program = Program(
        ops, name=name or f"{getattr(cfg, 'name', 'model')}/train-"
        f"{schedule}-p{n_stages}m{n_microbatches}", source="training",
        meta={"schedule": schedule, "n_stages": n_stages,
              "n_microbatches": n_microbatches, "seq_len": seq_len,
              "global_batch": global_batch, "dp_degree": dp_degree,
              "tp_degree": tp_degree, "n_accel": n_accel,
              "collective_algo": collective_algo,
              "fabric": fabric.describe() if fabric is not None else None,
              "tokens": tokens})
    res = engine.run(program, run_config)

    # measured bubble: pipeline body only (first F start -> last B end),
    # forward/backward compute time only — the quantity the analytic
    # (p-1)/(m+p-1) bound describes
    t0 = t1 = None
    busy = 0.0
    busy_all: Dict[str, float] = {}   # per-worker busy (non-idle) seconds
    for e in res.timeline.events:
        k = e.kind
        if k != "idle":
            w = e.worker
            busy_all[w] = busy_all.get(w, 0.0) + e.duration
        if k != "compute":
            continue
        nm = e.name
        if nm.startswith("F/"):
            t0 = e.start if t0 is None or e.start < t0 else t0
            busy += e.duration
        elif nm.startswith("B/"):
            end = e.start + e.duration
            t1 = end if t1 is None or end > t1 else t1
            busy += e.duration
    span = (t1 - t0) if (t0 is not None and t1 is not None) else 0.0
    bubble = (1.0 - busy / (n_stages * span)) if span > 0.0 else 0.0

    # device_utilization() and the per-device busy map share the single
    # event pass above (same accumulation order -> bit-identical floats)
    mk = res.timeline.makespan
    util = {d.name: (busy_all.get(d.name, 0.0) / mk if mk else 0.0)
            for d in run_config.resolved_topology().devices}
    if pinned:
        stage_util = {d: util.get(d, 0.0) for d in stage_devs}
    else:
        stage_util = util
    busy_by_dev = {w: v for w, v in busy_all.items() if w in util}

    return TrainingResult(
        program=program, engine=res, schedule=schedule, n_stages=n_stages,
        n_microbatches=n_microbatches, step_time_s=res.makespan,
        tokens=tokens, per_stage_busy_s=busy_by_dev,
        per_stage_utilization=stage_util,
        bubble_fraction=bubble,
        bubble_bound=bubble_bound(n_stages, n_microbatches),
        config=run_config,
        meta={"seq_len": seq_len, "global_batch": global_batch,
              "bytes_per_param": bytes_per_param,
              "bytes_per_act": bytes_per_act, "dp_degree": dp_degree,
              "tp_degree": tp_degree, "n_accel": n_accel,
              "collective_algo": collective_algo,
              "fabric": (fabric.describe()
                         if fabric is not None else None)})
