"""The port's design-space layer held against the JAX package's.

``sim/sweep.py`` (``sweep``, ``batched``, ``optimize``, ``topology_sweep``,
``as_records``, the lowering cache), ``sim/costmodel.py::CostModel``, the
decode lowering ``ir.from_decode``, ``ModelConfig.param_count`` /
``active_param_count``, ``core/scheduler.py::ThreadPool`` and the camera's
``frame_sweep`` / ``soc_frame_sweep`` go through both packages on the
reference tests' own inputs (``tests/test_sweep.py``,
``tests/test_costmodel.py``, ``tests/test_scheduler.py``) and the grids of
``benchmarks/bench_camera.py`` and ``benchmarks/bench_soc.py``.  The port
runs at the reference's TPU v5e constants passed explicitly
(``test_torch_sim.V5E``; graphs tiled for ``V5E_TILING``); every result of
the numpy paths is compared with ``==``.

Where a reference test lowers with ``from_training_step`` or
``from_collective``, each package lowers with its own and the two op lists
are held equal op for op.  Where it lowers with ``from_hlo`` (not ported
yet), the reference's lowering is built and each of its ops is turned
record by record into the port's ``CostedOp``: both packages price the
same op list.

The port's torch backend of ``CostModel`` (float64, ``torch.func``) is held
against the port's numpy backend at rtol 1e-9 (only the order of the row
sum differs) and against the reference's jax backend at the reference's own
tolerances (makespans rtol 1e-4, gradients rtol 5e-2 / atol 1e-3,
``tests/test_costmodel.py``).
"""
import dataclasses
import importlib
import threading
import time

import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from test_torch_sim import V5E, V5E_TILING, assert_same_result
from repro.apps import camera as jcamera
from repro.apps.paper_graphs import build_paper_graph as jbuild
from repro.configs import get_config as jget, get_smoke_config as jget_smoke
from repro.configs.gemma_2b import SMOKE as JSMOKE
from repro.configs.paper_nets import PAPER_NETS as JNETS
from repro.sim import costmodel as jcm
from repro.sim import engine as jengine
from repro.sim import hw as jhw
from repro.sim import ir as jir
from repro_torch.apps import camera as tcamera
from repro_torch.apps.paper_graphs import build_paper_graph as tbuild
from repro_torch.configs import (ARCH_IDS, get_config as tget,
                                 get_smoke_config as tget_smoke)
from repro_torch.configs.gemma_2b import SMOKE as TSMOKE
from repro_torch.configs.paper_nets import PAPER_NETS as TNETS
from repro_torch.core.energy import EnergyModel as TEnergyModel
from repro_torch.core.scheduler import ThreadPool as TThreadPool
from repro_torch.sim import costmodel as tcm
from repro_torch.sim import engine as tengine
from repro_torch.sim import hw as thw
from repro_torch.sim import ir as tir

# the packages re-export the sweep() function under the module's name
jsweep = importlib.import_module("repro.sim.sweep")
tsweep = importlib.import_module("repro_torch.sim.sweep")

CHAIN_IFACES = sorted(tcm.CHAIN_INTERFACES)

# tests/test_sweep.py's HLO dict and CONFIGS
HLO = {"flops": 1e15, "dot_flops": 9e14, "bytes": 1e12,
       "collective_bytes": 1e10, "wire_bytes": 1.5e10,
       "transcendentals": 1e9, "collectives": {}, "n_while": 1,
       "custom_calls": {}}
CONFIG_FIELDS = [dict(n_workers=1, interface="dma"),
                 dict(n_workers=4, interface="acp", hbm_ports=2),
                 dict(n_workers=8, interface="hbm", hbm_ports=4,
                      host_dispatch_s=1e-6)]

# benchmarks/bench_camera.py:27 PE_GRID, (workers, PE fraction), on its
# base point (:47); benchmarks/bench_soc.py:43-56 (frontends x accelerator
# counts x shared ports, the embedded base point)
PE_GRID = ((8, 1.0), (4, 0.5), (2, 0.25))
PE_BASE = dict(n_workers=8, interface="acp", hbm_ports=4)
SOC_GRID = [(frontend, n, ports) for frontend in ("cpu", "dsp")
            for n in (1, 2, 4, 8) for ports in (1.0, 4.0)]
SOC_BASE = dict(interface="dma", peak_flops=1.28e11, hbm_bw=25.6e9,
                vmem_bw=1e12, host_dispatch_s=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jcfg(**fields):
    return jengine.EngineConfig(**fields)


def tcfg(**fields):
    """The port's config at the v5e's constants, ``fields`` on top."""
    return tengine.EngineConfig(**{**V5E, **fields})


def to_port(jprog):
    """The reference's program as the port's: each op record by record."""
    return tir.Program([tir.CostedOp(**dataclasses.asdict(op))
                        for op in jprog.ops], name=jprog.name,
                       source=jprog.source, meta=dict(jprog.meta))


def both_programs(make):
    jprog = make()
    return jprog, to_port(jprog)


def lowered(make):
    """``make(ir, hw, model)`` through each package (the gemma_2b SMOKE
    config): the port's own lowering, held op for op against the
    reference's."""
    jprog, tprog = make(jir, jhw, JSMOKE), make(tir, thw, TSMOKE)
    assert_same_ops(jprog, tprog)
    return jprog, tprog


def hlo_chain(n_ops):
    return both_programs(lambda: jir.from_hlo(HLO, n_ops=n_ops))


def decode_programs(n_tokens, ops_per_token, **kw):
    return (jir.from_decode(JSMOKE, n_tokens=n_tokens,
                            ops_per_token=ops_per_token, **kw),
            tir.from_decode(TSMOKE, n_tokens=n_tokens,
                            ops_per_token=ops_per_token, **kw))


def graph_programs(net="lenet5", batch=1, max_tile_elems=2048):
    """The reference's ``lower_graph`` and the port's lowering of the same
    net tiled for the v5e (the port's ``lower_graph`` tiles for the
    H100)."""
    jg, tg = jbuild(JNETS[net], batch), tbuild(TNETS[net], batch)
    return (jsweep.lower_graph(jg, batch, max_tile_elems),
            tg.program(batch, max_tile_elems, target=V5E_TILING))


def same_results(js, ts):
    assert len(ts) == len(js)
    for j, t in zip(js, ts):
        assert_same_result(j, t)


def assert_same_ops(jprog, tprog):
    assert [dataclasses.astuple(op) for op in tprog.ops] == \
        [dataclasses.astuple(op) for op in jprog.ops]
    assert (tprog.name, tprog.source, tprog.meta) == \
        (jprog.name, jprog.source, jprog.meta)


# ---------------------------------------------------------------------------
# configs and the decode lowering


def test_param_counts_match_the_reference():
    for arch in ARCH_IDS:
        for tget_, jget_ in ((tget, jget), (tget_smoke, jget_smoke)):
            t, j = tget_(arch), jget_(arch)
            assert t.param_count() == j.param_count(), arch
            assert t.active_param_count() == j.active_param_count(), arch
            if t.moe is None:
                assert t.active_param_count() == t.param_count(), arch
            else:
                assert t.active_param_count() < t.param_count(), arch
    assert tget("falcon_mamba_7b").param_count() == 7_003_176_960
    assert (tget("granite_moe_1b_a400m").param_count(),
            tget("granite_moe_1b_a400m").active_param_count()) == \
        (1_334_627_328, 428_657_664)
    assert (tget("deepseek_v2_lite_16b").param_count(),
            tget("deepseek_v2_lite_16b").active_param_count()) == \
        (16_210_309_120, 2_663_231_488)


def test_active_param_count_moe_branch():
    """The MoE branch on a config built with the same fields in both
    packages, with a shared expert (granite_moe_1b_a400m has none)."""
    from repro.core.config import ModelConfig as JMC, MoEConfig as JMoE
    from repro_torch.core.config import ModelConfig as TMC, MoEConfig as TMoE
    fields = dict(name="moe", family="moe", n_layers=4, d_model=256,
                  n_heads=4, n_kv_heads=2, d_ff=512, vocab=1000)
    moe = dict(n_experts=8, top_k=2, n_shared=1, d_ff_expert=128)
    j, t = JMC(**fields, moe=JMoE(**moe)), TMC(**fields, moe=TMoE(**moe))
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count() \
        < t.param_count()


@pytest.mark.parametrize("arch,full,n_tokens,ops_per_token,kw", [
    ("gemma_2b", False, 12, 4, {}),
    ("gemma3_1b", True, 16, 8, dict(seq_len=1024, batch=4)),
    ("falcon_mamba_7b", True, 8, 3, dict(seq_len=300, batch=2,
                                         bytes_per_param=4.0)),
])
def test_from_decode_op_for_op(arch, full, n_tokens, ops_per_token, kw):
    jc = jget(arch) if full else jget_smoke(arch)
    tc = tget(arch) if full else tget_smoke(arch)
    jprog = jir.from_decode(jc, n_tokens, ops_per_token=ops_per_token, **kw)
    tprog = tir.from_decode(tc, n_tokens, ops_per_token=ops_per_token, **kw)
    assert len(tprog.ops) == n_tokens * ops_per_token
    assert_same_ops(jprog, tprog)
    assert tir._decode_terms(tc, 2.0) == jir._decode_terms(jc, 2.0)


def test_from_decode_shape_and_seriality():
    jprog, tprog = decode_programs(12, 4)
    assert len(tprog.ops) == 48
    assert tengine.prepare(tprog).is_chain
    # KV growth: later tokens read strictly more bytes
    first = sum(op.bytes_in for op in tprog.ops[:4])
    last = sum(op.bytes_in for op in tprog.ops[-4:])
    assert last > first
    assert_same_result(jengine.run(jprog, jcfg()), tengine.run(tprog, tcfg()))


# ---------------------------------------------------------------------------
# sweep(): executors, caches, records (tests/test_sweep.py)


def test_sweep_matches_individual_runs():
    jprog, tprog = graph_programs()
    tcfgs = [tcfg(**f) for f in CONFIG_FIELDS]
    results = tsweep.sweep(tprog, tcfgs)
    for cfg, res in zip(tcfgs, results):
        assert res.config is cfg
        assert_same_result(tengine.run(tprog, cfg), res)
    same_results(jsweep.sweep(jprog, [jcfg(**f) for f in CONFIG_FIELDS]),
                 results)


@pytest.mark.parametrize("executor", ["serial", "thread", "process"])
def test_sweep_executors_agree(executor):
    jprog, tprog = hlo_chain(16)
    tcfgs = [tcfg(**f) for f in CONFIG_FIELDS]
    base = jsweep.sweep(jprog, [jcfg(**f) for f in CONFIG_FIELDS],
                        executor="serial")
    same_results(base, tsweep.sweep(tprog, tcfgs, executor=executor))


def test_sweep_empty_and_bad_executor():
    _, tprog = hlo_chain(2)
    assert tsweep.sweep(tprog, []) == []
    with pytest.raises(ValueError):
        tsweep.sweep(tprog, [tcfg(**f) for f in CONFIG_FIELDS],
                     executor="carrier-pigeon")


def test_lower_graph_memoizes_on_digest_and_params():
    tsweep.clear_caches()
    g = tbuild(TNETS["lenet5"], 1)
    p1 = tsweep.lower_graph(g, batch=1, max_tile_elems=2048)
    assert tsweep.lower_graph(g, batch=1, max_tile_elems=2048) is p1
    assert tsweep.lower_graph(g, batch=1, max_tile_elems=4096) is not p1
    assert tsweep.lower_graph(g, batch=4, max_tile_elems=2048) is not p1
    # the key is the structural digest: a fresh identical graph hits, and
    # it digests as the reference's graph of the same recipe does
    g2 = tbuild(TNETS["lenet5"], 1)
    assert tsweep.graph_digest(g2) == tsweep.graph_digest(g)
    assert tsweep.lower_graph(g2, 1, 2048) is p1
    for net in TNETS:
        assert tsweep.graph_digest(tbuild(TNETS[net], 1)) == \
            jsweep.graph_digest(jbuild(JNETS[net], 1)), net
    g3 = tbuild(TNETS["cnn10"], 1)
    assert tsweep.graph_digest(g3) != tsweep.graph_digest(g)
    assert tsweep.lower_graph(g3, 1, 2048) is not p1
    tsweep.clear_caches()


def test_graph_digest_is_stable_per_object_across_lowering():
    """``from_graph`` backfills ``kernel`` and ``cin`` in place; the digest
    is pinned at first sight of the object, in both packages."""
    tsweep.clear_caches()
    jsweep.clear_caches()
    jg, tg = jbuild(JNETS["lenet5"], 1), tbuild(TNETS["lenet5"], 1)
    d0 = tsweep.graph_digest(tg)
    assert d0 == jsweep.graph_digest(jg)
    p1 = tsweep.lower_graph(tg, batch=1, max_tile_elems=2048)
    jsweep.lower_graph(jg, batch=1, max_tile_elems=2048)
    assert tsweep.graph_digest(tg) == d0 == jsweep.graph_digest(jg)
    assert tsweep.lower_graph(tg, batch=1, max_tile_elems=2048) is p1
    tsweep.clear_caches()


def test_lowering_caches_are_true_lru(monkeypatch):
    """A hit refreshes recency: the hot entry survives eviction while the
    cold one is dropped."""
    tsweep.clear_caches()
    monkeypatch.setattr(tsweep, "_CACHE_MAX", 2)
    g = tbuild(TNETS["lenet5"], 1)
    hot = tsweep.lower_graph(g, batch=1, max_tile_elems=2048)
    cold = tsweep.lower_graph(g, batch=2, max_tile_elems=2048)
    assert tsweep.lower_graph(g, 1, 2048) is hot
    tsweep.lower_graph(g, batch=3, max_tile_elems=2048)
    assert tsweep.lower_graph(g, 1, 2048) is hot
    assert tsweep.lower_graph(g, 2, 2048) is not cold
    tsweep.clear_caches()


def test_process_pool_creation_failure_falls_back_to_serial(monkeypatch):
    import concurrent.futures

    def refuse(*a, **k):
        raise OSError("no fork for you")

    monkeypatch.setattr(concurrent.futures, "ProcessPoolExecutor", refuse)
    _, tprog = hlo_chain(8)
    tcfgs = [tcfg(**f) for f in CONFIG_FIELDS]
    same_results(tsweep.sweep(tprog, tcfgs, executor="serial"),
                 tsweep.sweep(tprog, tcfgs, executor="process"))


def test_process_task_errors_propagate():
    _, tprog = hlo_chain(4)
    good = tcfg(**CONFIG_FIELDS[0])
    bad = dataclasses.replace(good, interface="carrier-pigeon")
    with pytest.raises(ValueError, match="interface"):
        tsweep.sweep(tprog, [good, bad], executor="process")


def test_as_records_is_tidy():
    jprog, tprog = hlo_chain(4)
    jrows = jsweep.as_records(jsweep.sweep(
        jprog, [jcfg(**f) for f in CONFIG_FIELDS]))
    trows = tsweep.as_records(tsweep.sweep(
        tprog, [tcfg(**f) for f in CONFIG_FIELDS]))
    assert trows == jrows
    for row, f in zip(trows, CONFIG_FIELDS):
        assert row["interface"] == f["interface"]
        assert row["n_workers"] == f["n_workers"]
        assert row["makespan_s"] > 0
        assert set(row) >= {"program", "n_ops", "makespan_s", "transfer_s",
                            "total_j", "utilization", "bound",
                            "relaxation_err"}


def test_utilization_counts_provisioned_workers():
    prog = tir.Program([tir.CostedOp("only", duration_s=1e-3)])
    res = tengine.run(prog, tcfg(n_workers=8))
    assert res.utilization() == pytest.approx(1.0 / 8.0)
    assert res.utilization("acc0") == pytest.approx(1.0)
    assert tengine.run(prog, tcfg(n_workers=1)).utilization() == \
        pytest.approx(1.0)


def _parallel_lanes():
    return lowered(lambda ir, hw, _: ir.Program(
        list(ir.from_collective("all_reduce", 32e6, (0, 1, 2, 3),
                                hw.Fabric.cluster(16), prefix="a").ops)
        + list(ir.from_collective("all_reduce", 32e6, (4, 5, 6, 7),
                                  hw.Fabric.cluster(16), prefix="b").ops),
        name="parallel-lanes"))


def test_batched_exact_on_fusion_resolvable_dag():
    jprog, tprog = _parallel_lanes()
    plan = tengine.prepare(tprog)
    assert not plan.is_chain and tengine.fusion_resolvable(plan)
    grid = [dict(ici_bw=b, ici_lat_s=l, n_workers=4)
            for b in (25e9, 100e9, 400e9) for l in (0.0, 1e-6)]
    tcfgs = [tcfg(**f) for f in grid]
    bs = tsweep.batched(tprog, tcfgs, top_k=3)
    jbs = jsweep.batched(jprog, [jcfg(**f) for f in grid], top_k=3)
    assert bs.exact and not bs.is_chain and bs.backend == "engine"
    np.testing.assert_array_equal(bs.lower, bs.upper)
    np.testing.assert_array_equal(bs.makespans, jbs.makespans)
    for m, c in zip(bs.makespans, tcfgs):
        assert float(m) == tengine.run(tprog, c).makespan
    assert [v["index"] for v in bs.verified] == \
        [v["index"] for v in jbs.verified]
    for v in bs.verified:
        assert v["relaxation_err"] == 0.0
        assert v["analytic_s"] == v["exact_s"]
    assert bs.best()["exact_s"] == min(float(m) for m in bs.makespans)
    _, chain = hlo_chain(8)
    assert tsweep.batched(chain, [tcfg()], top_k=1).exact


def test_topology_sweep_on_camera_socs():
    jprog, tprog = graph_programs("cnn10")
    jtopos = [jcamera.camera_soc(n, f, link_ports=p) for f, n, p in SOC_GRID]
    ttopos = [tcamera.camera_soc(n, f, link_ports=p) for f, n, p in SOC_GRID]
    js = jsweep.topology_sweep(jprog, jtopos, jcfg(**SOC_BASE))
    ts = tsweep.topology_sweep(tprog, ttopos, tcfg(**SOC_BASE))
    same_results(js, ts)
    assert tsweep.as_records(ts) == jsweep.as_records(js)


# ---------------------------------------------------------------------------
# CostModel, numpy: chains bit for bit (tests/test_costmodel.py)


def _rand_chain_records(rng, n=24):
    """tests/test_costmodel.py::_rand_chain's ops as plain records."""
    recs, prev = [], ()
    for i in range(n):
        kind = int(rng.integers(0, 5))
        if kind == 0:
            rec = dict(name=f"op{i}", deps=prev,
                       duration_s=float(rng.uniform(1e-6, 1e-3)))
        elif kind == 1:
            rec = dict(name=f"op{i}", deps=prev,
                       collective_bytes=float(rng.uniform(0, 1e8)),
                       wire_bytes=float(rng.uniform(0, 1e8)))
        else:
            rec = dict(
                name=f"op{i}", deps=prev,
                flops=float(rng.uniform(0, 1e12)),
                dot_flops=float(rng.uniform(0, 5e11)),
                bytes_in=float(rng.uniform(0, 1e9)),
                bytes_out=float(rng.uniform(0, 1e8)),
                transcendentals=float(rng.uniform(0, 1e6)),
                transfer_s=(float(rng.uniform(0, 1e-4))
                            if kind == 4 else None))
        recs.append(rec)
        prev = (f"op{i}",)
    return (jir.Program([jir.CostedOp(**r) for r in recs], name="rand_chain"),
            tir.Program([tir.CostedOp(**r) for r in recs], name="rand_chain"))


def _rand_fields(rng, iface):
    """tests/test_costmodel.py::_rand_config's fields."""
    return dict(
        interface=iface,
        n_workers=int(rng.integers(1, 9)),
        peak_flops=float(rng.uniform(1e13, 4e14)),
        datapath_scale=float(rng.choice((1.0, 0.5, 0.25))),
        hbm_bw=float(rng.uniform(1e11, 1.6e12)),
        vmem_bw=float(rng.uniform(1e12, 2e13)),
        ici_bw=float(rng.uniform(1e10, 1e11)),
        hbm_ports=float(rng.choice((0.0, 0.5, 1.0, 2.0, 4.0))),
        host_dispatch_s=float(rng.choice((0.0, 5e-7, 1e-6))),
        host_bw=float(rng.choice((0.0, 2e10))),
        host_threads=int(rng.integers(1, 5)))


def _matrix(hw, cfgs):
    return np.array([hw.params_from_config(c) for c in cfgs])


@pytest.mark.parametrize("iface", CHAIN_IFACES)
def test_chain_bit_identical_random_chains(iface):
    rng = np.random.default_rng(sum(map(ord, iface)))
    for _ in range(4):
        jprog, tprog = _rand_chain_records(rng)
        assert tengine.prepare(tprog).is_chain
        fields = [_rand_fields(rng, iface) for _ in range(6)]
        tcfgs = [tcfg(**f) for f in fields]
        jcfgs = [jcfg(**f) for f in fields]
        ms = tcm.CostModel(tprog, tcfgs[0], backend="numpy").makespans(
            _matrix(thw, tcfgs))
        np.testing.assert_array_equal(ms, jcm.CostModel(
            jprog, jcfgs[0], backend="numpy").makespans(_matrix(jhw, jcfgs)))
        for got, cfg in zip(ms, tcfgs):
            assert float(got) == tengine.run(tprog, cfg).makespan


@pytest.mark.parametrize("lowering", ["from_decode", "from_hlo"])
def test_chain_bit_identical_real_lowerings(lowering):
    jprog, tprog = (decode_programs(12, 4) if lowering == "from_decode"
                    else hlo_chain(16))
    assert tengine.prepare(tprog).is_chain
    rng = np.random.default_rng(3)
    for iface in CHAIN_IFACES:
        fields = [_rand_fields(rng, iface) for _ in range(4)]
        bs = tsweep.batched(tprog, [tcfg(**f) for f in fields],
                            top_k=len(fields))
        jbs = jsweep.batched(jprog, [jcfg(**f) for f in fields],
                             top_k=len(fields))
        assert bs.is_chain and bs.backend == "numpy"
        np.testing.assert_array_equal(bs.makespans, jbs.makespans)
        np.testing.assert_array_equal(bs.lower, bs.upper)
        assert [(v["index"], v["exact_s"]) for v in bs.verified] == \
            [(v["index"], v["exact_s"]) for v in jbs.verified]
        for v in bs.verified:
            assert v["relaxation_err"] == 0.0
            assert v["analytic_s"] == v["exact_s"]


@settings(max_examples=30, deadline=None)
@given(st.integers(min_value=0, max_value=2**32 - 1),
       st.sampled_from(CHAIN_IFACES))
def test_chain_bit_identical_property(seed, iface):
    rng = np.random.default_rng(seed)
    jprog, tprog = _rand_chain_records(rng, n=int(rng.integers(1, 16)))
    fields = _rand_fields(rng, iface)
    got = tcm.CostModel(tprog, tcfg(**fields), backend="numpy").makespan()
    assert got == tengine.run(tprog, tcfg(**fields)).makespan
    assert got == jcm.CostModel(jprog, jcfg(**fields),
                                backend="numpy").makespan()


def test_empty_program_is_zero():
    model = tcm.CostModel(tir.Program([], name="empty"), tcfg(),
                          backend="numpy")
    assert model.makespan() == 0.0
    lo, up = model.bounds(np.array([model.params0]))
    assert lo[0] == 0.0 and up[0] == 0.0


# ---------------------------------------------------------------------------
# CostModel, numpy: DAG brackets


def test_dag_bounds_bracket_tile_graph():
    jdag, tdag = graph_programs()
    assert not tengine.prepare(tdag).is_chain
    rng = np.random.default_rng(11)
    for iface in CHAIN_IFACES:
        for nw in (1, 2, 8):
            for _ in range(2):
                fields = {**_rand_fields(rng, iface), "n_workers": nw}
                t, j = tcfg(**fields), jcfg(**fields)
                lo, up = tcm.CostModel(tdag, t, backend="numpy").bounds(
                    np.array([thw.params_from_config(t)]))
                jlo, jup = jcm.CostModel(jdag, j, backend="numpy").bounds(
                    np.array([jhw.params_from_config(j)]))
                assert (lo[0], up[0]) == (jlo[0], jup[0])
                exact = tengine.run(tdag, t).makespan
                assert lo[0] <= exact * (1 + 1e-12), (iface, fields)
                assert exact <= up[0] * (1 + 1e-12), (iface, fields)
                err = tcm.relaxation_err(tengine.run(tdag, t))
                assert err == jcm.relaxation_err(jengine.run(jdag, j))
                assert err is not None and err <= 1e-12


def test_dag_single_worker_serial_chain_collapses():
    prog = tir.Program([tir.CostedOp(f"op{i}", duration_s=1e-4)
                        for i in range(8)], name="par8")
    cfg = tcfg(n_workers=1, interface="ideal")
    lo, up = tcm.CostModel(prog, cfg, backend="numpy").bounds(
        np.array([thw.params_from_config(cfg)]))
    exact = tengine.run(prog, cfg).makespan
    assert lo[0] == pytest.approx(exact, rel=1e-12)
    assert up[0] == pytest.approx(exact, rel=1e-12)


# ---------------------------------------------------------------------------
# the torch backend (float64, torch.func) on the CPU


def test_torch_backend_matches_numpy():
    rng = np.random.default_rng(21)
    progs = [decode_programs(16, 4)[1], hlo_chain(16)[1],
             _rand_chain_records(rng, 40)[1],
             _collective_programs()[0][1]]
    for iface in CHAIN_IFACES:
        cfgs = [tcfg(**_rand_fields(rng, iface)) for _ in range(8)]
        P = _matrix(thw, cfgs)
        for prog in progs:
            m_np = tcm.CostModel(prog, cfgs[0], backend="numpy")
            m_t = tcm.CostModel(prog, cfgs[0], backend="torch", device="cpu")
            assert m_t.backend == "torch" and m_t.device.type == "cpu"
            np.testing.assert_allclose(m_t.makespans(P), m_np.makespans(P),
                                       rtol=1e-9, atol=0)
            lo, up = m_t.bounds(P)
            np.testing.assert_array_equal(lo, up)


def test_torch_chain_matches_the_reference_jax_backend():
    jprog, tprog = decode_programs(16, 4)
    rng = np.random.default_rng(5)
    fields = [_rand_fields(rng, "hbm") for _ in range(8)]
    jcfgs, tcfgs = [jcfg(**f) for f in fields], [tcfg(**f) for f in fields]
    m_jx = jcm.CostModel(jprog, jcfgs[0], backend="jax")
    m_t = tcm.CostModel(tprog, tcfgs[0], backend="torch", device="cpu")
    np.testing.assert_allclose(m_t.makespans(_matrix(thw, tcfgs)),
                               m_jx.makespans(_matrix(jhw, jcfgs)),
                               rtol=1e-4)


@pytest.mark.parametrize("target_s", [None, 2e-3])
def test_torch_gradient_matches_jax_and_finite_differences(target_s):
    jprog, tprog = decode_programs(8, 4)
    space = {"peak_flops": (1e13, 4e14), "hbm_bw": (1e11, 1.6e12)}
    o_jx = jcm.CostModel(jprog, jcfg(), backend="jax").objective(
        space, target_s=target_s)
    o_t = tcm.CostModel(tprog, tcfg(), backend="torch",
                        device="cpu").objective(space, target_s=target_s)
    o_np = tcm.CostModel(tprog, tcfg(), backend="numpy").objective(
        space, target_s=target_s)
    assert (o_jx.backend, o_t.backend, o_np.backend) == \
        ("jax", "torch", "numpy")
    Z = np.array([[0.3, 0.7], [0.5, 0.5], [0.9, 0.1]])
    g = o_t.grad(Z)
    np.testing.assert_allclose(g, o_jx.grad(Z), rtol=5e-2, atol=1e-3)
    np.testing.assert_allclose(g, o_np.grad(Z), rtol=5e-2, atol=1e-3)
    np.testing.assert_array_equal(o_t.value(Z), o_np.value(Z))


def test_torch_backend_rejects_dags_and_auto_picks_by_shape():
    _, tdag = graph_programs()
    with pytest.raises(tcm.Unsupported):
        tcm.CostModel(tdag, tcfg(), backend="torch", device="cpu")
    assert tcm.CostModel(tdag, tcfg(), backend="auto").backend == "numpy"
    _, chain = decode_programs(4, 2)
    auto = tcm.CostModel(chain, tcfg(), backend="auto", device="cpu")
    assert auto.backend == "torch"
    assert tsweep.batched(chain, [tcfg()], backend="auto",
                          device="cpu").backend == "torch"


def test_torch_backend_asks_for_the_card(monkeypatch):
    """No device given means the card; without one it raises, and never
    falls back to numpy or the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, chain = decode_programs(4, 2)
    for backend in ("torch", "auto"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcm.CostModel(chain, tcfg(), backend=backend)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsweep.optimize(chain, {"hbm_bw": (1e11, 1e12)},
                        base_config=tcfg())
    # numpy never asks for a device
    assert tcm.CostModel(chain, tcfg(), backend="numpy").device is None


# ---------------------------------------------------------------------------
# optimize(): every field equal on numpy


def _same_optimum(t, j):
    assert (t.params, t.exact_s, t.analytic_s, t.relaxation_err,
            t.objective, t.feasible, t.target_s, t.backend, t.n_evals) == \
        (j.params, j.exact_s, j.analytic_s, j.relaxation_err, j.objective,
         j.feasible, j.target_s, j.backend, j.n_evals)
    assert [(c["params"], c["exact_s"], c["objective"], c["feasible"])
            for c in t.candidates] == \
        [(c["params"], c["exact_s"], c["objective"], c["feasible"])
         for c in j.candidates]
    assert_same_result(j.result, t.result)


SPACE = {"peak_flops": (1e13, 4e14), "hbm_bw": (1e11, 1.6e12)}
OPT_BASE = dict(interface="hbm", host_dispatch_s=1e-6)


def test_optimize_latency_hits_grid_best():
    jprog, tprog = decode_programs(12, 4)
    base = tcfg(**OPT_BASE)
    grid = [thw.apply_params(base, {"peak_flops": p, "hbm_bw": b})
            for p in np.geomspace(1e13, 4e14, 8)
            for b in np.geomspace(1e11, 1.6e12, 8)]
    grid_best = min(r.makespan for r in tsweep.sweep(tprog, grid))
    kw = dict(n_starts=4, steps=40, seed=0, backend="numpy")
    opt = tsweep.optimize(tprog, SPACE, base_config=base, **kw)
    _same_optimum(opt, jsweep.optimize(jprog, SPACE,
                                       base_config=jcfg(**OPT_BASE), **kw))
    assert opt.exact_s <= grid_best * 1.02
    assert opt.relaxation_err == 0.0
    assert opt.feasible is None and opt.n_evals > 0


def test_optimize_target_mode_prefers_feasible_cheap_designs():
    jprog, tprog = decode_programs(12, 4)
    base = tcfg(**OPT_BASE)
    lo = tengine.run(tprog, thw.apply_params(
        base, {"peak_flops": 1e13, "hbm_bw": 1e11})).makespan
    hi = tengine.run(tprog, thw.apply_params(
        base, {"peak_flops": 4e14, "hbm_bw": 1.6e12})).makespan
    target = float(np.sqrt(lo * hi))
    kw = dict(target_s=target, n_starts=6, steps=40, seed=0,
              backend="numpy")
    opt = tsweep.optimize(tprog, SPACE, base_config=base, **kw)
    _same_optimum(opt, jsweep.optimize(jprog, SPACE,
                                       base_config=jcfg(**OPT_BASE), **kw))
    assert opt.feasible is True
    assert opt.exact_s <= target * (1 + 1e-9)
    assert opt.objective < 1.0
    assert opt.candidates and opt.candidates[0]["config"] is opt.config


def test_optimize_torch_backend_verifies_on_the_engine():
    """The torch gradients steer; the exact engine picks the design."""
    _, tprog = decode_programs(12, 4)
    base = tcfg(**OPT_BASE)
    opt = tsweep.optimize(tprog, SPACE, base_config=base, n_starts=4,
                          steps=40, seed=0, device="cpu")
    # the analytic value is the torch row sum: equal to the engine's up to
    # the order of its additions
    assert opt.backend == "torch" and abs(opt.relaxation_err) <= 1e-9
    assert opt.exact_s == tengine.run(tprog, opt.config).makespan
    ref = tsweep.optimize(tprog, SPACE, base_config=base, n_starts=4,
                          steps=40, seed=0, backend="numpy")
    assert opt.exact_s <= ref.exact_s * 1.02


def test_optimize_rejects_topologies_and_unknown_fields():
    _, tprog = decode_programs(4, 2)
    topo_cfg = tcfg(topology=thw.SoCTopology.homogeneous(2))
    with pytest.raises(tcm.Unsupported):
        tsweep.optimize(tprog, {"hbm_bw": (1e11, 1e12)},
                        base_config=topo_cfg, device="cpu")
    with pytest.raises(ValueError):
        tsweep.optimize(tprog, {"warp_speed": (1.0, 2.0)},
                        base_config=tcfg(), device="cpu")


# ---------------------------------------------------------------------------
# parameter-vector mapping


def test_params_roundtrip():
    fields = dict(peak_flops=1e14, hbm_ports=2.0, host_dispatch_s=1e-6)
    t, j = tcfg(**fields), jcfg(**fields)
    vec = thw.params_from_config(t)
    assert vec == jhw.params_from_config(j)
    assert len(vec) == len(thw.PARAM_FIELDS)
    assert thw.params_from_config(thw.apply_params(tengine.EngineConfig(),
                                                   vec)) == vec
    bumped = thw.apply_params(t, {"hbm_bw": 5e11})
    assert bumped.hbm_bw == 5e11 and bumped.peak_flops == t.peak_flops


def test_params_dict_validates():
    with pytest.raises(ValueError):
        thw.params_dict({"not_a_knob": 1.0})
    with pytest.raises(ValueError):
        thw.params_dict([1.0, 2.0])


def test_with_ports_rewrites_every_link():
    topo = thw.SoCTopology.homogeneous(4)
    t2 = thw.with_ports(topo, 2.0)
    assert t2.links and all(l.ports == 2.0 for l in t2.links)
    two = thw.SoCTopology(devices=topo.devices,
                          links=(thw.Link("a", ports=1.0), thw.Link("b")))
    assert [l.ports for l in thw.with_ports(two, 0.5).links] == [0.5, 0.5]


# ---------------------------------------------------------------------------
# Unsupported boundaries: the event engine stays the universal path


def test_custom_interface_is_unsupported_but_still_runs():
    tengine.INTERFACES["probe-iface"] = lambda nbytes, cfg: (nbytes / 1e9,
                                                             0.0)
    try:
        _, tprog = decode_programs(4, 2)
        cfg = tcfg(interface="probe-iface")
        with pytest.raises(tcm.Unsupported):
            tcm.CostModel(tprog, cfg)
        res = tengine.run(tprog, cfg)
        assert res.makespan > 0
        assert tcm.relaxation_err(res) is None
    finally:
        del tengine.INTERFACES["probe-iface"]


def test_custom_energy_model_is_unsupported():
    class Doubled(TEnergyModel):
        pass

    _, tprog = decode_programs(4, 2)
    with pytest.raises(tcm.Unsupported):
        tcm.CostModel(tprog, tcfg(energy=Doubled()))


def test_heterogeneous_topology_is_unsupported():
    topo = thw.SoCTopology(devices=(thw.Device("big", peak_flops=2e14),
                                    thw.Device("small", peak_flops=5e13)))
    _, tprog = decode_programs(4, 2)
    with pytest.raises(tcm.Unsupported):
        tcm.CostModel(tprog, tcfg(topology=topo))


def test_unknown_backend_rejected():
    _, tprog = decode_programs(4, 2)
    with pytest.raises(ValueError):
        tcm.CostModel(tprog, backend="abacus")
    with pytest.raises(ValueError):
        tcm.CostModel(tprog, backend="jax")


# ---------------------------------------------------------------------------
# record plumbing


def test_as_records_relaxation_err_column():
    jprog, tprog = decode_programs(8, 4)
    grid = [{}, {"interface": "dma"}]
    trows = tsweep.as_records(tsweep.sweep(tprog, [tcfg(**f) for f in grid]))
    assert trows == jsweep.as_records(jsweep.sweep(
        jprog, [jcfg(**f) for f in grid]))
    assert all(row["relaxation_err"] == 0.0 for row in trows)
    jdag, tdag = graph_programs()
    trows = tsweep.as_records(tsweep.sweep(tdag, [tcfg(n_workers=4)]))
    assert trows == jsweep.as_records(jsweep.sweep(jdag, [jcfg(n_workers=4)]))
    assert trows[0]["relaxation_err"] <= 1e-12


def test_batched_records_and_best():
    jprog, tprog = decode_programs(8, 4)
    grid = [dict(peak_flops=p) for p in (5e13, 1e14, 2e14, 4e14)]
    bs = tsweep.batched(tprog, [tcfg(**f) for f in grid], top_k=2)
    jbs = jsweep.batched(jprog, [jcfg(**f) for f in grid], top_k=2)
    recs = bs.records()
    assert recs == jbs.records()
    exact_rows = [r for r in recs if r["exact_s"] is not None]
    assert len(exact_rows) == 2
    assert bs.best()["exact_s"] == min(r["exact_s"] for r in exact_rows)
    assert bs.top(1) == [int(np.argmin(bs.makespans))] == jbs.top(1)
    empty = tsweep.batched(tprog, [], top_k=3)
    assert empty.records() == [] and len(empty.makespans) == 0
    with pytest.raises(ValueError):
        tsweep.batched(tprog, [tcfg(**f) for f in grid], top_k=0).best()


# ---------------------------------------------------------------------------
# collectives in the analytic model (each package's own lowerings)


def _collective_programs():
    """(collective chain, multi-tier ring): tests/test_costmodel.py's
    ``_collective_chain()`` and its 8-way node-spanning all-reduce."""
    chain = lowered(lambda ir, hw, cfg: ir.from_training_step(
        cfg, seq_len=128, batch=4, dp_degree=4,
        fabric=hw.Fabric.single_tier(4)))
    ring = lowered(lambda ir, hw, _: ir.from_collective(
        "all_reduce", 64e6, 8, hw.Fabric.cluster(8)))
    return chain, ring


def test_collective_chain_bit_identical():
    (jprog, tprog), (jring, tring) = _collective_programs()
    assert tengine.prepare(tprog).is_chain
    grid = [{}, dict(ici_bw=10e9), dict(ici_lat_s=5e-6),
            dict(ici_bw=200e9, ici_lat_s=1e-6, peak_flops=5e13)]
    tcfgs, jcfgs = [tcfg(**f) for f in grid], [jcfg(**f) for f in grid]
    ms = tcm.CostModel(tprog, tcfgs[0], backend="numpy").makespans(
        _matrix(thw, tcfgs))
    np.testing.assert_array_equal(ms, jcm.CostModel(
        jprog, jcfgs[0], backend="numpy").makespans(_matrix(jhw, jcfgs)))
    for got, cfg in zip(ms, tcfgs):
        assert float(got) == tengine.run(tprog, cfg).makespan
    # the node-spanning ring charges the node tier's fields
    grid = [dict(node_bw=b, node_lat_s=l)
            for b, l in ((25e9, 0.0), (5e9, 1e-6), (100e9, 4e-6))]
    tcfgs = [tcfg(**f) for f in grid]
    assert tengine.prepare(tring).is_chain
    ms = tcm.CostModel(tring, tcfgs[0], backend="numpy").makespans(
        _matrix(thw, tcfgs))
    for got, cfg, f in zip(ms, tcfgs, grid):
        exact = tengine.run(tring, cfg).makespan
        assert float(got) == exact == jengine.run(jring, jcfg(**f)).makespan
        assert exact == pytest.approx(
            2 * 7 * (cfg.node_lat_s + (64e6 / 8) / cfg.node_bw), rel=1e-12)


def test_dag_bounds_bracket_collectives():
    progs = [lowered(lambda ir, hw, _: ir.from_collective(
        "all_reduce", 64e6, 16, hw.Fabric.cluster(16), algo="hierarchical")),
        _parallel_lanes()]
    fields = dict(ici_lat_s=1e-6, n_workers=4)
    for jprog, tprog in progs:
        exact = tengine.run(tprog, tcfg(**fields)).makespan
        assert exact == jengine.run(jprog, jcfg(**fields)).makespan
        model = tcm.CostModel(tprog, tcfg(**fields), backend="numpy")
        lo, up = model.bounds(np.array([model.params0]))
        jm = jcm.CostModel(jprog, jcfg(**fields), backend="numpy")
        jlo, jup = jm.bounds(np.array([jm.params0]))
        assert (lo[0], up[0]) == (jlo[0], jup[0])
        assert lo[0] <= exact * (1 + 1e-12)
        assert exact <= up[0] * (1 + 1e-12)
        assert lo[0] > 0.0


def test_batched_winner_matches_exact_on_collective_grid():
    jprog, tprog = lowered(lambda ir, hw, cfg: ir.Program(
        list(ir.from_training_step(cfg, seq_len=128, batch=4).ops)
        + list(ir.from_collective("all_reduce", 256e6, 8,
                                  hw.Fabric.cluster(8),
                                  deps=("train/update",),
                                  prefix="grad").ops),
        name="train+node-ring"))
    assert tengine.prepare(tprog).is_chain
    grid = [dict(node_bw=b, node_lat_s=l)
            for b in (5e9, 25e9, 100e9) for l in (0.0, 2e-6)]
    tcfgs = [tcfg(**f) for f in grid]
    bs = tsweep.batched(tprog, tcfgs, top_k=len(grid))
    jbs = jsweep.batched(jprog, [jcfg(**f) for f in grid], top_k=len(grid))
    np.testing.assert_array_equal(bs.makespans, jbs.makespans)
    exact = [tengine.run(tprog, c).makespan for c in tcfgs]
    assert bs.top(1) == [int(np.argmin(exact))]
    for v in bs.verified:
        assert v["analytic_s"] == v["exact_s"]


def test_fabric_overrides_are_unsupported_in_the_analytic_model():
    fab = thw.Fabric(tiers=(thw.FabricTier("ici", 8, bandwidth=99e9),))
    cfg = tcfg(fabric=fab)
    _, tprog = lowered(lambda ir, hw, _: ir.from_collective(
        "all_reduce", 1e6, 8, hw.Fabric(
            tiers=(hw.FabricTier("ici", 8, bandwidth=99e9),))))
    with pytest.raises(tcm.Unsupported):
        tcm.CostModel(tprog, cfg, backend="numpy")
    assert tengine.run(tprog, cfg).makespan > 0.0


# ---------------------------------------------------------------------------
# the camera's frame sweeps (the benchmarks' grids; no reference test)


def test_frame_sweep_on_the_pe_grid():
    """bench_camera's Fig 19/20 grid: CNN10 at batch 1, 16,384-element
    tiles, composed with the 720x1280 ISP under (workers, PE fraction)."""
    jdnn, tdnn = graph_programs("cnn10", 1, 16384)
    jbase, tbase = jcfg(**PE_BASE), tcfg(**PE_BASE)

    def grid(base):
        return [dataclasses.replace(base, n_workers=w,
                                    peak_flops=base.peak_flops * f,
                                    datapath_scale=f) for w, f in PE_GRID]
    jframe, jres = jcamera.frame_sweep(jdnn, grid(jbase))
    tframe, tres = tcamera.frame_sweep(tdnn, grid(tbase))
    assert_same_ops(jframe, tframe)
    same_results(jres, tres)
    for res in tres:
        assert set(res.per_phase) >= {"isp"}
        assert res.per_phase["isp"] < res.makespan


@pytest.mark.parametrize("base", ["embedded", "default"])
def test_soc_frame_sweep_on_the_soc_grid(base):
    """bench_soc's 16 topologies, CNN10 at 2048-element tiles, on its
    embedded base point and on a bare config."""
    jdnn, tdnn = graph_programs("cnn10", 1, 2048)
    jtopos = [jcamera.camera_soc(n, f, link_ports=p) for f, n, p in SOC_GRID]
    ttopos = [tcamera.camera_soc(n, f, link_ports=p) for f, n, p in SOC_GRID]
    fields = SOC_BASE if base == "embedded" else {}
    jcells = jcamera.soc_frame_sweep(jdnn, jtopos, jcfg(**fields))
    tcells = tcamera.soc_frame_sweep(tdnn, ttopos, tcfg(**fields))
    assert len(tcells) == len(SOC_GRID)
    for (jt, jf, jr), (tt, tf, tr), topo in zip(jcells, tcells, ttopos):
        assert tt is topo and tt.name == jt.name
        assert_same_ops(jf, tf)
        assert_same_result(jr, tr)
        assert tr.device_utilization() == jr.device_utilization()
        assert set(tr.per_device) >= {d.name for d in topo.devices}


# ---------------------------------------------------------------------------
# the host-side worker pool (tests/test_scheduler.py:63)


def test_thread_pool_parallel_and_correct():
    pool = TThreadPool(4)
    try:
        assert pool.map(lambda x: x * x, list(range(32))) == \
            [x * x for x in range(32)]

        def sleepy(_):
            time.sleep(0.02)
            return threading.current_thread().name
        t0 = time.time()
        names = pool.map(sleepy, range(8))
        assert time.time() - t0 < 8 * 0.02 * 0.9
        assert len(set(names)) > 1

        def boom(x):
            raise KeyError(x)
        with pytest.raises(KeyError):
            pool.map(boom, [1])
    finally:
        pool.shutdown()
    assert not any(th.is_alive() for th in pool._threads)
