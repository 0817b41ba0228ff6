"""The port's simulator held against the JAX package's, with ``==``.

The same inputs go through both packages: the five Table-III nets lowered by
each package's ``from_graph`` (built by each package's ``build_paper_graph``
at batch 1 and 2), seeded random chains and DAGs made as plain records (the
generators of ``tests/test_engine_equivalence.py``) and turned into each
package's ``CostedOp``, hand-built fabric hop ops, the camera ISP program
and SoC, and ``TileTask`` lists.  The port's defaults are the H100's, so its
side runs at the reference's TPU v5e constants passed explicitly: every
``EngineConfig`` field that defaults from ``hw`` (:data:`V5E`) and the tiling
target (:data:`V5E_TILING`).  The simulator is numpy in both packages and
the port's copy does the same float operations in the same order, so every
result (makespan, per-kind, per-device, breakdown, roofline, energy, the
timeline's events) is compared with ``==``, no tolerance.

The last tests check what only the port has: its H100 defaults, and the
tiling invariants of ``tests/test_tiling.py`` at the H100's target.
"""
import dataclasses
import math
import random

import pytest

from _hyp import given, settings, st
from repro.apps import camera as jcamera
from repro.apps.paper_graphs import build_paper_graph as ref_build
from repro.configs.paper_nets import PAPER_NETS as REF_NETS
from repro.core import scheduler as jsched
from repro.core import tiling as jtiling
from repro.sim import backends as jbackends
from repro.sim import engine as jengine
from repro.sim import hw as jhw
from repro.sim import ir as jir
from repro_torch.apps import camera as tcamera
from repro_torch.apps.paper_graphs import build_paper_graph
from repro_torch.configs.paper_nets import PAPER_NETS
from repro_torch.core import scheduler as tsched
from repro_torch.core import tiling as ttiling
from repro_torch.core.tensor import TensorSpec
from repro_torch.sim import backends as tbackends
from repro_torch.sim import engine as tengine
from repro_torch.sim import hw as thw
from repro_torch.sim import ir as tir

NETS = tuple(PAPER_NETS)
# every EngineConfig field whose default the port takes from its hw module
HW_FIELDS = {"peak_flops": "PEAK_FLOPS", "hbm_bw": "HBM_BW",
             "vmem_bw": "VMEM_BW", "ici_bw": "ICI_BW",
             "ici_lat_s": "ICI_LAT_S", "node_bw": "NODE_BW",
             "node_lat_s": "NODE_LAT_S", "inter_bw": "INTER_BW",
             "inter_lat_s": "INTER_LAT_S"}
V5E = {field: getattr(jhw, const) for field, const in HW_FIELDS.items()}
V5E_TILING = ttiling.TilingTarget(
    reduce_quantum=jtiling.MXU_DIM, hbm_bw=jtiling.HBM_BW,
    copy_latency_s=jtiling.HBM_LATENCY_US * 1e-6)

# (interface, n_workers, hbm_ports, host dispatch on) — the flat configs
FLAT = [(iface, n, ports, host)
        for iface in ("hbm", "dma", "acp", "ideal")
        for n, ports in ((1, 0), (4, 0), (4, 1))
        for host in (False, True)]


def configs(iface, n, ports, host, **kw):
    """The reference's config and the port's, the port's at the v5e's
    constants: equal field for field."""
    fields = dict(n_workers=n, interface=iface, hbm_ports=ports, **kw)
    if host:
        fields.update(host_dispatch_s=2e-6, host_bw=20e9, host_threads=4)
    return (jengine.EngineConfig(**fields),
            tengine.EngineConfig(**{**V5E, **fields}))


def _events(tl):
    return [(e.worker, e.name, e.start, e.duration, e.kind, e.phase)
            for e in tl.events]


def assert_same_result(j, t):
    """Every metric of two runs, the reference's and the port's, ``==``."""
    assert t.makespan == j.makespan
    assert t.per_kind == j.per_kind
    assert t.per_phase == j.per_phase
    assert t.per_device == j.per_device
    assert t.device_utilization() == j.device_utilization()
    assert t.utilization() == j.utilization()
    assert dataclasses.astuple(t.breakdown) == dataclasses.astuple(j.breakdown)
    assert t.roofline.to_dict() == j.roofline.to_dict()
    assert t.energy == j.energy
    assert _events(t.timeline) == _events(j.timeline)


# ---------------------------------------------------------------------------
# from_graph, op for op

OP_FIELDS = ("name", "flops", "dot_flops", "bytes_in", "bytes_out", "deps",
             "affinity", "phase", "device_class", "tile", "op_kind")


def _programs(net, batch, **kw):
    jprog = ref_build(REF_NETS[net], batch).program(batch, **kw)
    tprog = build_paper_graph(PAPER_NETS[net], batch).program(
        batch, target=V5E_TILING, **kw)
    return jprog, tprog


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("net", NETS)
def test_from_graph_op_for_op(net, batch):
    jprog, tprog = _programs(net, batch)
    assert len(tprog.ops) == len(jprog.ops) > 0
    for j, t in zip(jprog.ops, tprog.ops):
        assert ({f: getattr(t, f) for f in OP_FIELDS}
                == {f: getattr(j, f) for f in OP_FIELDS})
    assert (tprog.name, tprog.source, tprog.meta) == \
        (jprog.name, jprog.source, jprog.meta)
    assert tprog.totals() == jprog.totals()


@pytest.mark.parametrize("net", NETS)
def test_from_graph_at_other_tile_sizes(net):
    """One tile a node (the largest node's elements) and a small budget."""
    for max_tile_elems in (4096, 1 << 22):
        jprog, tprog = _programs(net, 2, max_tile_elems=max_tile_elems)
        assert [tuple(getattr(t, f) for f in OP_FIELDS) for t in tprog.ops] \
            == [tuple(getattr(j, f) for f in OP_FIELDS) for j in jprog.ops]


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("net", NETS)
def test_engine_on_the_nets(net, batch):
    """Each net under every flat config, the engine choosing its path."""
    jprog, tprog = _programs(net, batch)
    for cfg in FLAT:
        j, t = configs(*cfg)
        assert_same_result(jengine.run(jprog, j, model_flops=1e9),
                           tengine.run(tprog, t, model_flops=1e9))


@pytest.mark.parametrize("net", NETS)
def test_engine_on_the_nets_both_cores(net):
    """The dict event loop and the fused core, each against its
    counterpart, at batch 2."""
    jprog, tprog = _programs(net, 2)
    for cfg in FLAT[::3]:
        j, t = configs(*cfg)
        for fuse in (False, True):
            assert_same_result(jengine.run(jprog, j, fuse=fuse),
                               tengine.run(tprog, t, fuse=fuse))


# ---------------------------------------------------------------------------
# seeded random chains and DAGs (tests/test_engine_equivalence.py's shapes)


def random_records(rng: random.Random, n: int, chain: bool):
    recs = []
    for i in range(n):
        if chain:
            deps, aff = ((f"op{i-1}",) if i else ()), None
        else:
            deps = tuple(f"op{j}" for j in range(max(0, i - 6), i)
                         if rng.random() < 0.35)
            aff = rng.choice([None, None, None, "red0", "red1"])
        recs.append(dict(
            name=f"op{i}",
            flops=rng.choice([0.0, 1e6, 5e8, 2e9]),
            dot_flops=rng.choice([0.0, 1e6, 4e8]),
            bytes_in=rng.choice([0.0, 1e5, 3e7, 2e8]),
            bytes_out=rng.choice([0.0, 1e5, 2e6]),
            collective_bytes=rng.choice([0.0, 0.0, 1e6]),
            wire_bytes=rng.choice([0.0, 2e6]),
            transcendentals=rng.choice([0.0, 1e5]),
            deps=deps, affinity=aff, phase=f"ph{i % 3}",
            duration_s=rng.choice([None, None, None, 1e-4, 0.0]),
            transfer_s=rng.choice([None, None, None, 0.0, 2e-5])))
    return recs


def both_programs(recs, name="rand"):
    return (jir.Program([jir.CostedOp(**r) for r in recs], name=name),
            tir.Program([tir.CostedOp(**r) for r in recs], name=name))


@pytest.mark.parametrize("cfg", FLAT, ids=lambda c: "-".join(map(str, c))
                         if isinstance(c, tuple) else str(c))
@pytest.mark.parametrize("chain", [False, True])
def test_engine_on_random_programs(chain, cfg):
    rng = random.Random(1234 + chain)
    j, t = configs(*cfg)
    for _ in range(6):
        jprog, tprog = both_programs(random_records(
            rng, rng.randint(1, 60), chain))
        assert_same_result(jengine.run(jprog, j, model_flops=1e9),
                           tengine.run(tprog, t, model_flops=1e9))


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_fast_and_fuse_both_ways(fast, fuse):
    """The chain fast path forced on and off, the fused core on and off:
    each of the port's paths against the reference's same path."""
    rng = random.Random(7 + 2 * fast + fuse)
    for k in range(8):
        chain = k % 2 == 0
        jprog, tprog = both_programs(random_records(
            rng, rng.randint(2, 50), chain))
        jplan, tplan = jengine.prepare(jprog), tengine.prepare(tprog)
        assert tplan.is_chain == jplan.is_chain
        assert tplan.is_chain or not chain
        for cfg in FLAT[::2]:
            j, t = configs(*cfg)
            assert_same_result(
                jengine.run(jprog, j, plan=jplan, fast=fast, fuse=fuse),
                tengine.run(tprog, t, plan=tplan, fast=fast, fuse=fuse))


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_property_random_dags_match_reference(data):
    seed = data.draw(st.integers(min_value=0, max_value=2**20))
    n = data.draw(st.integers(min_value=1, max_value=40))
    chain = data.draw(st.booleans())
    cfg = FLAT[data.draw(st.integers(min_value=0, max_value=len(FLAT) - 1))]
    jprog, tprog = both_programs(random_records(random.Random(seed), n,
                                                chain))
    j, t = configs(*cfg)
    assert_same_result(jengine.run(jprog, j), tengine.run(tprog, t))


def test_chain_op_costs_match():
    rng = random.Random(3)
    jprog, tprog = both_programs(random_records(rng, 30, True))
    for cfg in FLAT:
        j, t = configs(*cfg)
        for jop, top in zip(jprog.ops, tprog.ops):
            assert tengine.chain_op_costs(top, t) == \
                jengine.chain_op_costs(jop, j)


# ---------------------------------------------------------------------------
# topologies: the camera SoC, explicit devices, fabric tiers


def test_camera_program_and_soc():
    for kw in ({}, {"hw": (64, 96), "dnn_hw": (16, 16),
                    "device_class": "dsp"}, {"device_class": "accel"}):
        jp, tp = jcamera.camera_program(**kw), tcamera.camera_program(**kw)
        assert [dataclasses.astuple(op) for op in tp.ops] == \
            [dataclasses.astuple(op) for op in jp.ops]
        assert (tp.name, tp.source, tp.meta) == (jp.name, jp.source, jp.meta)
    for kw in ({}, {"n_accels": 2, "frontend": "dsp", "link_ports": 1.0}):
        js, ts = jcamera.camera_soc(**kw), tcamera.camera_soc(**kw)
        assert ts.name == js.name and ts.describe() == js.describe()
        assert [dataclasses.astuple(d) for d in ts.devices] == \
            [dataclasses.astuple(d) for d in js.devices]
        assert [dataclasses.astuple(l) for l in ts.links] == \
            [dataclasses.astuple(l) for l in js.links]
    assert tcamera.FRONTEND_PEAK == jcamera.FRONTEND_PEAK


@pytest.mark.parametrize("frontend", ["cpu", "dsp"])
@pytest.mark.parametrize("net", ["cnn10", "lenet5"])
def test_camera_frame_on_the_soc(net, frontend):
    """The ISP on the SoC's frontend device, the net on its accelerators:
    one heterogeneous run in each package."""
    jnet, tnet = _programs(net, 1)
    jframe = jcamera.camera_program((96, 128), device_class=frontend) \
        .then(jnet, name="frame")
    tframe = tcamera.camera_program((96, 128), device_class=frontend) \
        .then(tnet, name="frame")
    for iface in ("hbm", "dma"):
        for host in (False, True):
            j, t = configs(iface, 1, 0, host)
            j = dataclasses.replace(j, topology=jcamera.camera_soc(
                2, frontend))
            t = dataclasses.replace(t, topology=tcamera.camera_soc(
                2, frontend))
            jr, tr = jengine.run(jframe, j), tengine.run(tframe, t)
            assert_same_result(jr, tr)
            assert set(tr.per_device) >= {f"{frontend}0", "acc0"}


def test_device_level_overrides():
    """Devices with their own peak, interface, bandwidth, link and cost
    backend on two links, against the same topology in the reference."""
    def topo(hw, backends):
        return hw.SoCTopology(
            devices=(hw.Device("cpu0", kind="cpu", peak_flops=5e10,
                               interface="acp", link="host"),
                     hw.Device("acc0", hbm_bw=4e11, datapath_scale=0.5,
                               cost_backend=backends.SystolicBackend(
                                   rows=64, cols=32)),
                     hw.Device("acc1", peak_flops=1e14, link="host",
                               interface="dma")),
            links=(hw.Link("hbm", ports=1.0),
                   hw.Link("host", bandwidth=5e10, ports=0.5)))
    rng = random.Random(17)
    for _ in range(6):
        recs = random_records(rng, 40, False)
        for i, r in enumerate(recs):
            r["device_class"] = ("cpu", "accel", "accel")[i % 3]
            r["tile"] = (rng.choice([16, 100, 128]), 64, 288)
            r["op_kind"] = rng.choice(["conv", "matmul", ""])
        jprog, tprog = both_programs(recs)
        for cfg in FLAT[::4]:
            j, t = configs(*cfg)
            j = dataclasses.replace(j, topology=topo(jhw, jbackends))
            t = dataclasses.replace(t, topology=topo(thw, tbackends))
            assert_same_result(jengine.run(jprog, j), tengine.run(tprog, t))


def _hop_ops(ir, fabric, rng):
    """Two parallel collective lanes of hand-built fabric hops (ring steps
    on ``ici`` within a chip, on ``node`` across chips), a compute op
    before and after each."""
    recs = []
    for prefix, members in (("a", (0, 1, 2, 3)), ("b", (2, 5, 9, 12))):
        tier = fabric.tiers[fabric.span_tier(members)].name
        lane = fabric.lane(members)
        recs.append(dict(name=f"{prefix}/pre", flops=1e8, bytes_in=1e6,
                         bytes_out=1e6))
        prev = f"{prefix}/pre"
        for s in range(rng.randint(2, 6)):
            nbytes = rng.choice([1e5, 4e6])
            recs.append(dict(name=f"{prefix}/hop{s}", collective_bytes=nbytes,
                             wire_bytes=nbytes, deps=(prev,), tier=tier,
                             lane=lane, hops=rng.choice([1.0, 3.0]),
                             phase="coll"))
            prev = f"{prefix}/hop{s}"
        recs.append(dict(name=f"{prefix}/post", flops=2e8, bytes_in=2e6,
                         deps=(prev,)))
    return ir.Program([ir.CostedOp(**r) for r in recs], name="lanes")


def test_fabric_hops_on_lanes():
    jfab, tfab = jhw.Fabric.cluster(16), thw.Fabric.cluster(16)
    assert tfab.describe() == jfab.describe()
    for members in ((0, 1), (0, 5), (3, 7, 11), (0, 15)):
        assert tfab.lane(members) == jfab.lane(members)
        assert tfab.span_tier(members) == jfab.span_tier(members)
    rng_j, rng_t = random.Random(5), random.Random(5)
    for _ in range(5):
        jprog, tprog = _hop_ops(jir, jfab, rng_j), _hop_ops(tir, tfab, rng_t)
        assert tir.linear_runs(tprog.ops) == jir.linear_runs(jprog.ops)
        for kw in ({}, {"ici_bw": 10e9, "ici_lat_s": 2e-6},
                   {"node_bw": 5e9, "node_lat_s": 1e-6, "hbm_ports": 2}):
            j, t = configs("hbm", 4, kw.pop("hbm_ports", 0), False, **kw)
            for fuse in (False, True):
                assert_same_result(
                    jengine.run(jprog, dataclasses.replace(j, fabric=jfab),
                                fuse=fuse),
                    tengine.run(tprog, dataclasses.replace(t, fabric=tfab),
                                fuse=fuse))
        assert thw.resolve_tier_params(t, "node") == \
            jhw.resolve_tier_params(j, "node")


def test_param_vector_round_trip():
    j, t = configs("acp", 4, 1, True)
    assert thw.params_from_config(t) == jhw.params_from_config(j)
    assert thw.PARAM_FIELDS == jhw.PARAM_FIELDS
    p = {"peak_flops": 1e14, "host_threads": 2.5}
    assert thw.params_from_config(thw.apply_params(t, p)) == \
        jhw.params_from_config(jhw.apply_params(j, p))
    assert thw.tco_per_step(8, 1.5, 3e4) == jhw.tco_per_step(8, 1.5, 3e4)
    ts = thw.with_ports(tcamera.camera_soc(), 2.0)
    js = jhw.with_ports(jcamera.camera_soc(), 2.0)
    assert [dataclasses.astuple(l) for l in ts.links] == \
        [dataclasses.astuple(l) for l in js.links]


# ---------------------------------------------------------------------------
# cost backends


def _table(backends):
    return backends.TableBackend(samples=(
        ("matmul", 1e6, 3e-6), ("matmul", 1e8, 2e-5), ("matmul", 1e10, 1e-3),
        ("conv", 5e7, 9e-6), ("", 1e9, 2e-4)))


BACKENDS = {
    "roofline": lambda b: b.RooflineBackend(),
    "roofline-name": lambda b: "roofline",
    "systolic": lambda b: b.SystolicBackend(),
    "systolic-small": lambda b: b.SystolicBackend(
        rows=32, cols=16, double_buffered=False, im2col=False),
    "table": _table,
}


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("net", ["cnn10", "vgg16"])
def test_backends_on_the_nets(net, backend):
    jprog, tprog = _programs(net, 2)
    for jop, top in zip(jprog.ops, tprog.ops):
        jb = jbackends.get_backend(BACKENDS[backend](jbackends))
        tb = tbackends.get_backend(BACKENDS[backend](tbackends))
        j, t = configs("hbm", 1, 0, False)
        assert tb.op_time(top, t) == jb.op_time(jop, j)
    for cfg in FLAT[::5]:
        j, t = configs(*cfg, cost_backend=BACKENDS[backend](jbackends))
        t = dataclasses.replace(t,
                                cost_backend=BACKENDS[backend](tbackends))
        assert_same_result(jengine.run(jprog, j), tengine.run(tprog, t))


def test_backend_registry():
    assert tbackends.is_roofline(None) and tbackends.is_roofline("roofline")
    assert tbackends.is_roofline(tbackends.ROOFLINE)
    assert not tbackends.is_roofline(tbackends.SystolicBackend())
    assert isinstance(tbackends.get_backend("systolic"),
                      tbackends.SystolicBackend)
    assert isinstance(tbackends.ROOFLINE, tbackends.CostBackend)
    with pytest.raises(ValueError, match="unknown cost backend"):
        tbackends.get_backend("nope")
    with pytest.raises(TypeError):
        tbackends.get_backend(3.0)
    for tile in ((), (128, 128, 64), (100, 30, 7), (0, 5, 5)):
        for kw in ({}, {"rows": 64, "double_buffered": False}):
            assert tbackends.SystolicBackend(**kw).utilization(tile) == \
                jbackends.SystolicBackend(**kw).utilization(tile)


# ---------------------------------------------------------------------------
# the scheduler and the graph's task view


@pytest.mark.parametrize("penalty", [0.0, 0.3])
@pytest.mark.parametrize("n_workers", [1, 3])
def test_scheduler_simulate(n_workers, penalty):
    rng = random.Random(n_workers)
    recs = [dict(name=f"l{i // 4}/t{i % 4}",
                 duration=rng.choice([1e-5, 3e-5]),
                 affinity=rng.choice([None, "red"]),
                 transfer=rng.choice([0.0, 2e-6]),
                 deps=(f"l{i // 4 - 1}/t{i % 4}",) if i >= 4 else ())
            for i in range(24)]
    jtl = jsched.simulate([jsched.TileTask(**r) for r in recs], n_workers,
                          penalty)
    ttl = tsched.simulate([tsched.TileTask(**r) for r in recs], n_workers,
                          penalty)
    assert _events(ttl) == _events(jtl)
    assert ttl.makespan == jtl.makespan
    assert ttl.utilization() == jtl.utilization()
    assert ttl.per_kind() == jtl.per_kind()


@pytest.mark.parametrize("net", NETS)
def test_graph_tile_tasks(net):
    """The task view is the program's ops priced at the port's hw (the
    H100's) constants, as the reference prices them at its own."""
    jg = ref_build(REF_NETS[net], 1)
    tg = build_paper_graph(PAPER_NETS[net], 1)
    jtasks = jg.tile_tasks(1)
    ttasks = tg.tile_tasks(1, target=V5E_TILING)
    jops = jg.program(1).ops
    assert [(t.name, t.affinity, t.deps) for t in ttasks] == \
        [(t.name, t.affinity, t.deps) for t in jtasks]
    assert [(t.duration, t.transfer) for t in ttasks] == \
        [(max(op.flops / thw.PEAK_FLOPS, 1e-9), op.bytes / thw.HBM_BW)
         for op in jops]
    assert [(t.duration, t.transfer) for t in jtasks] == \
        [(max(op.flops / jhw.PEAK_FLOPS, 1e-9), op.bytes / jhw.HBM_BW)
         for op in jops]
    assert _events(tsched.simulate(ttasks, 2)) == _events(jsched.simulate(
        [jsched.TileTask(t.name, t.duration, t.affinity, t.transfer, t.deps)
         for t in ttasks], 2))


# ---------------------------------------------------------------------------
# the port's own defaults: one H100


def test_bare_config_is_one_h100():
    cfg = tengine.EngineConfig()
    for field, const in HW_FIELDS.items():
        assert getattr(cfg, field) == getattr(thw, const)
    assert (cfg.peak_flops, cfg.hbm_bw) == (67e12, 3.35e12)
    assert cfg.vmem_bw == 132 * 128 * 1.98e9
    assert (cfg.ici_bw, cfg.node_bw, cfg.inter_bw) == (900e9, 900e9, 50e9)
    assert thw.HOST_OVERHEAD_S == 42.0e-6
    for field, const in HW_FIELDS.items():     # no v5e value survives
        assert getattr(thw, const) != getattr(jhw, const), field
    assert thw.H100.peak_flops == cfg.peak_flops
    # the H100 preset as an explicit device prices as the bare config
    rng = random.Random(9)
    prog = tir.Program([tir.CostedOp(**r)
                        for r in random_records(rng, 30, False)])
    explicit = dataclasses.replace(cfg, topology=thw.SoCTopology(
        devices=(thw.H100,)))
    a, b = tengine.run(prog, cfg), tengine.run(prog, explicit)
    assert (a.makespan, a.per_kind) == (b.makespan, b.per_kind)


def test_tiling_target_defaults_to_the_h100():
    assert ttiling.H100.reduce_quantum == 32
    assert ttiling.H100.hbm_bw == thw.HBM_BW
    spec = TensorSpec((2, 16, 16, 96), "NHWC", "float32")
    assert ttiling.choose_tiling(spec, 4096, "C") == \
        ttiling.choose_tiling(spec, 4096, "C", target=ttiling.H100)
    # at the v5e's target the chooser is the reference's, choice for choice
    for shape in ((1, 32, 32, 64), (4, 8, 8, 512), (1, 1, 1, 4096)):
        spec = TensorSpec(shape, "NHWC", "float32")
        jspec = jtiling.TensorSpec(shape, "NHWC", "float32")
        for budget in (1024, 16384):
            t = ttiling.choose_tiling(spec, budget, "C", target=V5E_TILING)
            j = jtiling.choose_tiling(jspec, budget, "C")
            assert dataclasses.astuple(t) == dataclasses.astuple(j)


dims_st = st.tuples(st.sampled_from([1, 2, 4]),
                    st.sampled_from([4, 8, 16, 64]),
                    st.sampled_from([4, 8, 16, 64]),
                    st.sampled_from([8, 32, 128, 512]))


@given(shape=dims_st, budget=st.sampled_from([1024, 4096, 16384, 65536]))
@settings(max_examples=60, deadline=None)
def test_h100_tiles_fit_budget_and_cover(shape, budget):
    """``tests/test_tiling.py``'s invariants at the H100's target."""
    spec = TensorSpec(shape, "NHWC", "float32")
    for c in ttiling.enumerate_tilings(spec, budget, reduce_dim="C"):
        assert math.prod(c.tile_shape) <= budget
        covered = 1
        for full, t in zip(shape, c.tile_shape):
            assert 1 <= t <= full
            covered *= math.ceil(full / t)
        assert covered == c.n_tiles
        assert c.n_memcpys >= 1
        assert c.contiguous_run >= 1


@pytest.mark.parametrize("net", NETS)
def test_h100_program_counts_its_tiles(net):
    """At the H100's defaults each node lowers to its chosen tiling's tile
    count, and a net's flops do not depend on the tiling."""
    g = build_paper_graph(PAPER_NETS[net], 2)
    prog = g.program(2)
    one = g.program(2, max_tile_elems=1 << 30)
    names = [n for n in g.order if g.nodes[n].op not in ("input", "weight")]
    assert len(one.ops) == len(names)
    assert {op.phase for op in prog.ops} == set(names)
    assert math.isclose(prog.total("flops"), one.total("flops"), rel_tol=1e-12)
    res = tengine.run(prog, tengine.EngineConfig())
    assert math.isfinite(res.makespan) and res.makespan > 0
