"""The port's cluster layer (fabric collectives, DP x TP x PP training,
placements, TCO) held against the JAX package's, with ``==``.

Every case of ``tests/test_cluster.py`` and ``tests/test_collectives.py``
runs on the port's own objects with the reference test's assertions, and
once more against the reference on identical inputs: the lowered per-hop
ops op for op, ``collective_time``, the engine's makespans, every field of
each ``TrainingResult`` (``test_torch_training.assert_same_training``) and
the cluster records, all with ``==``.  The port's side runs at the
reference's TPU v5e constants passed explicitly (``test_torch_sim.V5E``):
the reference's single-tier identities hold at its zero ICI latency, and
the port's default is the H100's NVLink hop, 2 us.  The hypothesis
properties go through ``_hyp``.

The last tests cover what only the port has: the H100's default fabric
rates, and a DGX H100 layout (8 GPUs on one NVSwitch, InfiniBand between
nodes: ``Fabric.cluster(n, accels_per_chip=8, chips_per_node=1)``), whose
node tier of group size 1 never carries a hop.
"""
import dataclasses
import importlib
import math

import pytest
import torch

from _hyp import given, settings, st
from test_torch_sim import V5E
from test_torch_training import (JTOY, TOY, assert_same_ops,
                                 assert_same_training)
from repro.sim import engine as jengine
from repro.sim import hw as jhw
from repro.sim import ir as jir
from repro.sim import training as jtraining
from repro_torch.apps.serving import default_config
from repro_torch.core.config import ModelConfig
from repro_torch.sim import engine, hw, ir, training
from repro_torch.sim.engine import EngineConfig
from repro_torch.sim.hw import Fabric, FabricTier, tco_per_step
from repro_torch.sim.ir import collective_time, from_collective
from repro_torch.sim.sweep import (as_cluster_records, cluster_sweep,
                                   placements_for)

# the package re-exports the sweep() function under the module's name
jsweep = importlib.import_module("repro.sim.sweep")

REL = 1e-12

# nonzero per-hop ICI latency so the latency terms of the bounds are
# exercised (tests/test_collectives.py's CONFIG), at the v5e's rates
CONFIG = EngineConfig(**{**V5E, "ici_lat_s": 2e-6})
JCONFIG = jengine.EngineConfig(ici_lat_s=2e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tcfg(**fields):
    return EngineConfig(**{**V5E, **fields})


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-300)


def _jfabric(fab):
    """The reference's copy of a port ``Fabric``."""
    return jhw.Fabric(tiers=tuple(jhw.FabricTier(**dataclasses.asdict(t))
                                  for t in fab.tiers), name=fab.name)


def both_collective(kind, nbytes, group, fab=None, **kw):
    """The port's lowering, asserted op for op against the reference's."""
    prog = from_collective(kind, nbytes, group, fab, **kw)
    jprog = jir.from_collective(kind, nbytes, group,
                                None if fab is None else _jfabric(fab), **kw)
    assert_same_ops(jprog, prog)
    return prog


def _run(prog, config=CONFIG):
    return engine.run(prog, config).makespan


def both_time(kind, nbytes, group, fab, config=CONFIG, jconfig=JCONFIG,
              **kw):
    """``collective_time`` of both packages, asserted ``==``."""
    t = collective_time(kind, nbytes, group, fab, config=config, **kw)
    j = jir.collective_time(kind, nbytes, group, _jfabric(fab),
                            config=jconfig, **kw)
    assert t == j
    return t


def both_run(prog, fields):
    """The port's program through both engines (the reference's as
    records), makespans asserted ``==``."""
    jprog = jir.Program([jir.CostedOp(**dataclasses.asdict(op))
                         for op in prog.ops], name=prog.name)
    t = engine.run(prog, tcfg(**fields)).makespan
    assert t == jengine.run(jprog, jengine.EngineConfig(**fields)).makespan
    return t


def both_sim(jfab=None, tfab=None, **kw):
    """``simulate_training`` at the v5e's defaults in both packages."""
    j = jtraining.simulate_training(JTOY, fabric=jfab, **kw)
    t = training.simulate_training(TOY, config=tcfg(), fabric=tfab, **kw)
    assert_same_training(j, t)
    return t


# ---------------------------------------------------------------------------
# fabric data model (tests/test_cluster.py)


def test_fabric_shapes():
    fab = Fabric.cluster(64)
    assert fab.n_accel == 64
    assert fab.describe() == "4ici x 8node x 2inter"
    assert fab.leaves_per_group() == (4, 32, 64)
    assert Fabric.cluster(4).describe() == "4ici"
    assert Fabric.cluster(8).describe() == "4ici x 2node"
    assert Fabric.single_tier(8).n_accel == 8
    for n in (1, 4, 8, 64, 512):
        assert Fabric.cluster(n).describe() == \
            jhw.Fabric.cluster(n).describe()


def test_span_tier_and_lanes():
    fab = Fabric.cluster(64)
    assert fab.span_tier((0, 1, 2, 3)) == 0          # one chip
    assert fab.span_tier((0, 4)) == 1                # two chips, one node
    assert fab.span_tier((0, 32)) == 2               # two nodes
    assert fab.lane((0, 1, 2, 3)) == "ici:0"
    assert fab.lane((4, 5)) == "ici:4"
    assert fab.lane((0, 32)) == "inter:0"
    # same tier, disjoint leading member -> distinct physical links
    assert fab.lane((0, 4)) != fab.lane((8, 12))


def test_placements_cover_the_accelerator_count():
    for n in (8, 64, 512):
        cells = placements_for(n)
        assert cells == jsweep.placements_for(n), n
        assert cells, n
        assert all(dp * pp * tp == n for dp, pp, tp in cells)
        assert len(set(cells)) == len(cells)
    assert (512 // 64, 8, 8) in placements_for(512)  # all three degrees > 1
    assert placements_for(64, max_tp=4, max_pp=2) == \
        jsweep.placements_for(64, max_tp=4, max_pp=2)


def test_tco_monotone():
    base = tco_per_step(8, 0.1, 100.0)
    assert tco_per_step(16, 0.1, 100.0) > base       # more capex
    assert tco_per_step(8, 0.1, 200.0) > base        # more energy
    assert tco_per_step(8, 0.2, 100.0) > base        # longer amortized step
    assert tco_per_step(8, 0.0, 0.0) == 0.0
    for args in ((8, 0.1, 100.0), (512, 2.5, 3e5)):
        assert tco_per_step(*args) == jhw.tco_per_step(*args)


# ---------------------------------------------------------------------------
# bit-identity with the pre-fabric simulator


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_stages=2, n_microbatches=4),
    dict(n_stages=4, n_microbatches=8, schedule="gpipe"),
    dict(dp_degree=4),
    dict(n_stages=2, n_microbatches=2, dp_degree=2),
])
def test_single_tier_fabric_training_bit_identical(kw):
    """Attaching a single-tier fabric at the v5e's zero ICI latency must
    not move any reported float of a no-dp cell; every run equal to the
    reference's."""
    a = both_sim(global_batch=8, **kw)
    b = both_sim(global_batch=8, jfab=jhw.Fabric.single_tier(16),
                 tfab=Fabric.single_tier(16), **kw)
    if "dp_degree" in kw:
        # dp lowers through the fabric: same collective lane total as the
        # flat ring wire accounting (checked below), but the per-hop
        # schedule differs — identity applies to the no-dp cells
        assert b.step_time_s > 0.0
        return
    assert a.step_time_s == b.step_time_s
    assert a.stats() == b.stats()
    assert a.engine.energy["total_j"] == b.engine.energy["total_j"]


MAKERS = [
    (lambda m, c: m.from_decode(c, 8)),
    (lambda m, c: m.from_serving_step(c, prefill_lens=(64, 32),
                                      decode_positions=(10, 20))),
    (lambda m, c: m.from_training_step(c, seq_len=128, batch=4)),
    (lambda m, c: m.from_training_step(c, seq_len=128, batch=4,
                                       dp_degree=4)),
]


@pytest.mark.parametrize("make", MAKERS,
                         ids=["decode", "serving", "train", "train-dp"])
def test_config_fabric_is_invisible_without_tier_ops(make):
    """A fabric on the CONFIG changes nothing for programs without tier
    ops: chain fast path, event loop, energy, roofline all bit-identical;
    the programs and makespans equal to the reference's."""
    prog = make(ir, TOY)
    assert_same_ops(make(jir, JTOY), prog)
    cfg = tcfg()
    cfg_fab = dataclasses.replace(cfg, fabric=Fabric.single_tier(8))
    a = engine.run(prog, cfg)
    b = engine.run(prog, cfg_fab)
    assert a.makespan == b.makespan
    assert a.breakdown == b.breakdown
    assert a.energy["total_j"] == b.energy["total_j"]
    assert a.roofline.step_s == b.roofline.step_s
    assert a.makespan == jengine.run(make(jir, JTOY),
                                     jengine.EngineConfig()).makespan


def test_dp_ring_matches_pre_refactor_wire_term():
    """The per-hop ring's lane total == the flat op's ring wire
    accounting ``2 (d-1)/d grad_bytes / ici_bw`` (rel 1e-12)."""
    cfg = tcfg()
    for d in (2, 4, 8):
        r = both_sim(global_batch=8, dp_degree=d,
                     jfab=jhw.Fabric.single_tier(8),
                     tfab=Fabric.single_tier(8))
        legacy = ir.from_training_step(TOY, seq_len=512, batch=8,
                                       dp_degree=d)
        wire = next(op.wire_bytes for op in legacy.ops
                    if op.name == "train/reduce")
        assert _rel(r.stats()["collective_s"], wire / cfg.ici_bw) <= REL


# ---------------------------------------------------------------------------
# DP x TP x PP over the fabric


def test_tp_requires_fabric_and_placement_must_fit():
    with pytest.raises(ValueError):
        training.simulate_training(TOY, global_batch=8, tp_degree=2)
    with pytest.raises(ValueError):
        training.simulate_training(TOY, global_batch=8, dp_degree=4,
                                   tp_degree=4,
                                   fabric=Fabric.single_tier(8))
    with pytest.raises(ValueError, match="requires a fabric"):
        ir.from_training_step(TOY, tp_degree=2)
    with pytest.raises(ValueError, match="overlap_dp requires a fabric"):
        ir.from_training_step(TOY, dp_degree=2, overlap_dp=True)


def test_tp_shrinks_compute_and_adds_collectives():
    fab, jfab = Fabric.cluster(8), jhw.Fabric.cluster(8)
    r1 = both_sim(global_batch=8, jfab=jfab, tfab=fab)
    r2 = both_sim(global_batch=8, tp_degree=4, jfab=jfab, tfab=fab)
    assert r2.stats()["collective_s"] > 0.0
    assert r1.stats()["collective_s"] == 0.0
    # per-rank flops drop 4x; the program records that in the fwd op
    f1 = next(o for o in r1.program.ops if o.name.startswith("F/"))
    f2 = next(o for o in r2.program.ops if o.name.startswith("F/"))
    assert f2.flops == pytest.approx(f1.flops / 4.0, rel=1e-12)


def test_pp_boundary_crosses_the_right_tier():
    """With 4-accel chips and tp=4, adjacent pipeline stages live on
    different chips of one node: the boundary hop rides the node tier."""
    fab, jfab = Fabric.cluster(32), jhw.Fabric.cluster(32)
    r = both_sim(global_batch=8, n_stages=2, n_microbatches=2,
                 tp_degree=4, jfab=jfab, tfab=fab)
    x = [op for op in r.program.ops if op.name.startswith("xF/")]
    assert x and all(op.tier == "node" for op in x)
    # tp=1: adjacent stages share a chip -> device transfer
    r2 = both_sim(global_batch=8, n_stages=2, n_microbatches=2,
                  jfab=jfab, tfab=fab)
    x2 = [op for op in r2.program.ops if op.name.startswith("xF/")]
    assert x2 and all(op.tier is None and op.bytes_in > 0 for op in x2)


def test_dp_overlap_across_stages():
    """Each stage's gradient all-reduce chains after ITS last backward,
    so the reduce phase of late stages overlaps earlier backwards."""
    r = both_sim(global_batch=8, n_stages=4, n_microbatches=4,
                 dp_degree=4, jfab=jhw.Fabric.cluster(16),
                 tfab=Fabric.cluster(16))
    dp_starts = sorted(e.start for e in r.engine.timeline.events
                       if "train/dp" in e.name)
    b_ends = sorted(e.start + e.duration
                    for e in r.engine.timeline.events
                    if e.name.startswith("B/"))
    assert dp_starts and dp_starts[0] < b_ends[-1]


@pytest.mark.parametrize("algo", ["ring", "tree", "hierarchical"])
def test_overlapped_dp_and_tp_dp_pp_step_equal_the_reference(algo):
    """``from_training_step`` with TP, DP and ``overlap_dp`` on a
    three-tier fabric, and a dp x pp x tp step over it, op for op."""
    fab, jfab = Fabric.cluster(64), jhw.Fabric.cluster(64)
    kw = dict(seq_len=128, batch=4, dp_degree=4, tp_degree=4,
              collective_algo=algo, overlap_dp=True)
    assert_same_ops(jir.from_training_step(JTOY, fabric=jfab, **kw),
                    ir.from_training_step(TOY, fabric=fab, **kw))
    both_sim(global_batch=8, n_stages=4, n_microbatches=4, dp_degree=4,
             tp_degree=4, collective_algo=algo, jfab=jfab, tfab=fab)


def test_cluster_records_columns_and_sanity():
    kw = dict(n_accel_grid=(8,), algos=("ring", "hierarchical"),
              placements=[(2, 2, 2), (8, 1, 1)], global_batch=16)
    results = cluster_sweep(TOY, base_config=tcfg(), **kw)
    jresults = jsweep.cluster_sweep(JTOY, **kw)
    for j, t in zip(jresults, results):
        assert_same_training(j, t)
    rows = as_cluster_records(results)
    assert rows == jsweep.as_cluster_records(jresults)
    assert len(rows) == 4
    need = {"n_accel", "dp_degree", "pp_degree", "tp_degree",
            "collective_algo", "step_time_s", "cluster_tokens_per_s",
            "replica_j", "cluster_j", "tco_usd_per_step",
            "tco_usd_per_mtok", "collective_s", "fabric"}
    for r in rows:
        assert need <= set(r)
        assert r["step_time_s"] > 0.0
        assert r["tco_usd_per_step"] > 0.0
        assert r["cluster_j"] >= r["replica_j"]


@pytest.mark.slow
def test_large_grid_hierarchical_never_loses_slow():
    """512-accel grid: hierarchical <= ring in every node/inter-spanning
    dp cell; every row equal to the reference's."""
    kw = dict(n_accel_grid=(512,), algos=("ring", "hierarchical"),
              max_tp=4, max_pp=4, global_batch=32)
    rows = as_cluster_records(cluster_sweep(TOY, base_config=tcfg(), **kw))
    assert rows == jsweep.as_cluster_records(jsweep.cluster_sweep(JTOY,
                                                                  **kw))
    by_cell = {}
    for r in rows:
        key = (r["dp_degree"], r["pp_degree"], r["tp_degree"])
        by_cell.setdefault(key, {})[r["collective_algo"]] = \
            r["step_time_s"]
    assert by_cell
    for key, cell in by_cell.items():
        assert cell["hierarchical"] <= cell["ring"] * (1.0 + 1e-9), key


# ---------------------------------------------------------------------------
# collectives: closed forms, exact (tests/test_collectives.py)


@pytest.mark.parametrize("p", [2, 3, 4, 8, 16])
def test_ring_all_reduce_closed_form(p):
    """Engine makespan == 2 (p-1)/p B/bw + 2 (p-1) lat, rel <= 1e-12."""
    B = 96e6
    fab = Fabric.single_tier(p)
    lat, bw = hw.resolve_tier_params(CONFIG, "ici")
    assert (lat, bw) == jhw.resolve_tier_params(JCONFIG, "ici")
    t = _run(both_collective("all_reduce", B, p, fab))
    closed = 2.0 * (p - 1) / p * B / bw + 2.0 * (p - 1) * lat
    assert _rel(t, closed) <= REL
    assert both_time("all_reduce", B, p, fab) == t


@pytest.mark.parametrize("p", [2, 3, 8])
def test_ring_engine_equals_python_sum_bitwise(p):
    """The engine IS the left-to-right accumulation of the hop costs."""
    B = 50e6
    fab = Fabric.single_tier(p)
    lat, bw = hw.resolve_tier_params(CONFIG, "ici")
    t = _run(both_collective("all_reduce", B, p, fab))
    acc = 0.0
    for _ in range(2 * (p - 1)):        # 2(p-1) steps of B/p on one lane
        acc += lat + (B / p) / bw
    assert t == acc


@pytest.mark.parametrize("kind", ["reduce_scatter", "all_gather"])
@pytest.mark.parametrize("p", [2, 4, 16])
def test_ring_rs_ag_closed_form(kind, p):
    B = 96e6
    fab = Fabric.single_tier(p)
    lat, bw = hw.resolve_tier_params(CONFIG, "ici")
    t = _run(both_collective(kind, B, p, fab))
    closed = (p - 1) / p * B / bw + (p - 1) * lat
    assert _rel(t, closed) <= REL


@pytest.mark.parametrize("p", [2, 3, 4, 8, 16])
def test_tree_all_reduce_log_depth(p):
    """Tree all-reduce: 2 ceil(log2 p) full-size hops — log-latency
    depth, no (p-1)/p bandwidth discount."""
    B = 96e6
    fab = Fabric.single_tier(p)
    lat, bw = hw.resolve_tier_params(CONFIG, "ici")
    t = _run(both_collective("all_reduce", B, p, fab, algo="tree"))
    depth = max(1, (p - 1).bit_length())
    assert _rel(t, 2.0 * depth * (lat + B / bw)) <= REL
    assert depth == math.ceil(math.log2(p)) or p == 1


@pytest.mark.parametrize("kind", ["reduce_scatter", "all_gather"])
def test_tree_rs_ag_halve_per_level(kind):
    """Tree reduce-scatter / all-gather: recursive halving / doubling,
    op for op with the reference."""
    prog = both_collective(kind, 64e6, 8, Fabric.single_tier(8),
                           algo="tree")
    sizes = [op.collective_bytes for op in prog.ops]
    want = [64e6 / 2, 64e6 / 4, 64e6 / 8]
    assert sizes == (want if kind == "reduce_scatter" else want[::-1])


def test_tree_beats_ring_when_latency_dominates():
    """Tiny payload, many members: O(log p) latency < O(p) latency."""
    p, B = 32, 8.0
    fab = Fabric.single_tier(p)
    ring = both_time("all_reduce", B, p, fab)
    tree = both_time("all_reduce", B, p, fab, algo="tree")
    assert tree < ring


@pytest.mark.parametrize("p", [2, 4, 8])
def test_all_to_all_closed_form(p):
    B = 64e6
    fab = Fabric.single_tier(p)
    lat, bw = hw.resolve_tier_params(CONFIG, "ici")
    t = _run(both_collective("all_to_all", B, p, fab))
    assert _rel(t, (p - 1) * (lat + (B / p) / bw)) <= REL


def test_hierarchical_composed_per_tier_bound():
    """2-tier hierarchical all-reduce == ring-RS within the inner tier
    + ring all-reduce of B/k across the tier leads + ring-AG back, each
    phase priced at ITS tier's latency/bandwidth."""
    k, n = 4, 4
    fab = Fabric(tiers=(FabricTier("node", k), FabricTier("inter", n)))
    B = 128e6
    lat_n, bw_n = hw.resolve_tier_params(CONFIG, "node")
    lat_i, bw_i = hw.resolve_tier_params(CONFIG, "inter")
    t = _run(both_collective("all_reduce", B, k * n, fab,
                             algo="hierarchical"))
    rs = (k - 1) * (lat_n + (B / k) / bw_n)
    ar = 2.0 * (n - 1) * (lat_i + (B / (k * n)) / bw_i)
    assert _rel(t, 2.0 * rs + ar) <= REL
    assert both_time("all_reduce", B, k * n, fab, algo="hierarchical") == t


def test_hierarchical_le_ring_on_multi_tier():
    """The hierarchical decomposition never loses to a flat ring on the
    slow spanning tier (bandwidths decrease outward by construction)."""
    fab = Fabric.cluster(64)
    for p in (8, 16, 32, 64):
        ring = both_time("all_reduce", 128e6, p, fab)
        hier = both_time("all_reduce", 128e6, p, fab, algo="hierarchical")
        assert hier <= ring * (1.0 + REL)


def test_count_compression_is_exact():
    """count=c back-to-back collectives cost exactly c x one (steps
    serialize on the lane, so bytes and hops scale together)."""
    fab = Fabric.single_tier(8)
    one = both_time("all_reduce", 32e6, 8, fab)
    three = both_time("all_reduce", 32e6, 8, fab, count=3.0)
    assert _rel(three, 3.0 * one) <= REL


# ---------------------------------------------------------------------------
# collectives: structure — no-op identity, lanes, errors


def _toy():
    return ModelConfig(name="toy", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
                       head_dim=16)


def test_one_member_group_is_noop_bit_identical():
    assert both_collective("all_reduce", 1e9, (3,)).ops == []
    assert both_collective("all_to_all", 1e9, 1).ops == []
    base = ir.from_decode(_toy(), 4)
    merged = ir.Program(list(base.ops)
                        + list(from_collective("all_reduce", 1e9, 1).ops),
                        name=base.name)
    a = engine.run(base, CONFIG)
    b = engine.run(merged, CONFIG)
    assert a.makespan == b.makespan
    assert a.energy["total_j"] == b.energy["total_j"]


def test_same_lane_serializes_disjoint_lanes_parallel():
    fab = Fabric.single_tier(8)
    g1, g2 = tuple(range(4)), tuple(range(4, 8))
    one = _run(both_collective("all_reduce", 64e6, g1, fab))
    both_same = _run(ir.Program(
        list(both_collective("all_reduce", 64e6, g1, fab,
                             prefix="a").ops)
        + list(both_collective("all_reduce", 64e6, g1, fab,
                               prefix="b").ops), name="same-lane"))
    both_disjoint = _run(ir.Program(
        list(both_collective("all_reduce", 64e6, g1, fab,
                             prefix="a").ops)
        + list(both_collective("all_reduce", 64e6, g2, fab,
                               prefix="b").ops), name="disjoint"))
    assert _rel(both_same, 2.0 * one) <= REL    # same links: serialized
    assert _rel(both_disjoint, one) <= REL      # disjoint links: parallel


def test_hierarchical_subgroups_run_in_parallel():
    """Phase 1/3 of hierarchical run one ring per inner group on
    DISJOINT lanes: the makespan charges one group's ring, not k."""
    k, n = 4, 2
    fab = Fabric(tiers=(FabricTier("node", k), FabricTier("inter", n)))
    B = 64e6
    prog = both_collective("all_reduce", B, k * n, fab, algo="hierarchical")
    lanes = {op.lane for op in prog.ops if op.name.startswith("c/rs")
             or "/rs" in op.name}
    assert len({op.lane for op in prog.ops}) >= 3   # 2 rs/ag lanes + inter
    assert both_run(prog, dict(ici_lat_s=2e-6)) == both_time(
        "all_reduce", B, k * n, fab, algo="hierarchical")
    assert lanes  # sanity: reduce-scatter phase exists


def test_validation_errors():
    fab = Fabric.single_tier(4)
    with pytest.raises(ValueError):
        from_collective("bogus", 1e6, 4, fab)
    with pytest.raises(ValueError):
        from_collective("all_reduce", 1e6, 4, fab, algo="bogus")
    with pytest.raises(ValueError):
        Fabric(tiers=(FabricTier("bogus", 4),))
    with pytest.raises(ValueError):
        # tiers must come in canonical inner-to-outer order
        Fabric(tiers=(FabricTier("inter", 2), FabricTier("ici", 4)))
    with pytest.raises(ValueError, match="duplicate"):
        from_collective("all_reduce", 1e6, (0, 1, 1), fab)
    with pytest.raises(ValueError, match="all_reduce only"):
        from_collective("all_gather", 1e6, 8, Fabric.cluster(8),
                        algo="hierarchical")
    assert (ir.COLLECTIVE_KINDS, ir.COLLECTIVE_ALGOS) == \
        (jir.COLLECTIVE_KINDS, jir.COLLECTIVE_ALGOS)


# ---------------------------------------------------------------------------
# property tests: monotonicity


@settings(max_examples=40, deadline=None)
@given(b1=st.floats(1e3, 1e9), b2=st.floats(1e3, 1e9),
       algo=st.sampled_from(["ring", "tree", "hierarchical"]))
def test_monotone_in_bytes(b1, b2, algo):
    lo, hi = sorted((b1, b2))
    fab = Fabric.cluster(16)
    t_lo = both_time("all_reduce", lo, 16, fab, algo=algo)
    t_hi = both_time("all_reduce", hi, 16, fab, algo=algo)
    assert t_lo <= t_hi * (1.0 + REL)


@settings(max_examples=30, deadline=None)
@given(p1=st.integers(1, 32), p2=st.integers(1, 32))
def test_ring_monotone_in_group_size(p1, p2):
    lo, hi = sorted((p1, p2))
    fab = Fabric.single_tier(32)
    t_lo = both_time("all_reduce", 64e6, lo, fab)
    t_hi = both_time("all_reduce", 64e6, hi, fab)
    assert t_lo <= t_hi * (1.0 + REL)


@settings(max_examples=30, deadline=None)
@given(lat1=st.floats(0.0, 1e-4), lat2=st.floats(0.0, 1e-4),
       algo=st.sampled_from(["ring", "tree", "hierarchical"]))
def test_monotone_in_per_tier_latency(lat1, lat2, algo):
    lo, hi = sorted((lat1, lat2))
    fab = Fabric.cluster(16)
    c_lo = dataclasses.replace(CONFIG, node_lat_s=lo, ici_lat_s=lo)
    c_hi = dataclasses.replace(CONFIG, node_lat_s=hi, ici_lat_s=hi)
    j_lo = dataclasses.replace(JCONFIG, node_lat_s=lo, ici_lat_s=lo)
    j_hi = dataclasses.replace(JCONFIG, node_lat_s=hi, ici_lat_s=hi)
    t_lo = both_time("all_reduce", 16e6, 16, fab, algo=algo, config=c_lo,
                     jconfig=j_lo)
    t_hi = both_time("all_reduce", 16e6, 16, fab, algo=algo, config=c_hi,
                     jconfig=j_hi)
    assert t_lo <= t_hi * (1.0 + REL)


# ---------------------------------------------------------------------------
# the port's own: H100 rates and the DGX H100 layout


def test_h100_defaults_price_an_nvlink_ring():
    """``collective_time`` at the port's default config: a ring over one
    NVSwitch group at the H100's NVLink rate and its 2 us hop."""
    B, p = 96e6, 8
    t = collective_time("all_reduce", B, p, Fabric.single_tier(p))
    assert t == collective_time("all_reduce", B, p, Fabric.single_tier(p),
                                config=EngineConfig())
    closed = 2.0 * (p - 1) * (hw.ICI_LAT_S + (B / p) / hw.ICI_BW)
    assert _rel(t, closed) <= REL
    assert (hw.ICI_LAT_S, hw.ICI_BW) == (2e-6, 900e9)


def test_dgx_layout_node_tier_of_one_never_carries_a_hop():
    """8 GPUs on one NVSwitch (``ici``), nodes on InfiniBand (``inter``):
    the size-1 ``node`` tier spans nothing, so a group inside a node rides
    NVLink and one across nodes InfiniBand, and the hierarchical
    all-reduce is the per-tier composition at the H100's rates."""
    fab = Fabric.cluster(64, accels_per_chip=8, chips_per_node=1)
    assert fab.describe() == "8ici x 1node x 8inter"
    assert fab.leaves_per_group() == (8, 8, 64)
    assert fab.span_tier(range(8)) == 0
    assert fab.span_tier((0, 8)) == 2
    assert Fabric.cluster(8, accels_per_chip=8,
                          chips_per_node=1).describe() == "8ici"
    B, cfg = 256e6, EngineConfig()
    for algo in ("ring", "tree", "hierarchical"):
        prog = from_collective("all_reduce", B, 64, fab, algo=algo)
        assert {op.tier for op in prog.ops} <= {"ici", "inter"}
    t = collective_time("all_reduce", B, 64, fab, algo="hierarchical",
                        config=cfg)
    k, n = 8, 8
    rs = (k - 1) * (hw.ICI_LAT_S + (B / k) / hw.ICI_BW)
    ar = 2.0 * (n - 1) * (hw.INTER_LAT_S + (B / (k * n)) / hw.INTER_BW)
    assert _rel(t, 2.0 * rs + ar) <= REL
    assert t < collective_time("all_reduce", B, 64, fab, config=cfg)


def test_dgx_layout_cluster_sweep_equals_the_reference():
    """``cluster_sweep`` on the DGX layout, at the v5e's rates in both
    packages, row for row; then at the H100's bf16 defaults, finite."""
    kw = dict(n_accel_grid=(8, 64), algos=("ring", "hierarchical"),
              placements=[(8, 1, 1), (2, 2, 2), (64, 1, 1), (8, 2, 4)],
              global_batch=32, accels_per_chip=8, chips_per_node=1)
    results = cluster_sweep(TOY, base_config=tcfg(), **kw)
    jresults = jsweep.cluster_sweep(JTOY, **kw)
    assert len(results) == 8
    for j, t in zip(jresults, results):
        assert_same_training(j, t)
    assert as_cluster_records(results) == \
        jsweep.as_cluster_records(jresults)
    rows = as_cluster_records(cluster_sweep(
        TOY, base_config=default_config(), **kw))
    for r in rows:
        assert math.isfinite(r["step_time_s"]) and r["step_time_s"] > 0.0
    assert {r["fabric"] for r in rows} == {"8ici", "8ici x 1node x 8inter"}
