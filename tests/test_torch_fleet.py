"""The port's fleet-scale serving replay held against the JAX package's.

Every case of ``tests/test_fleet.py`` (the memoized ``StepCostTable``, the
lite ``replay_serving``, the replica fleet with its routers and autoscaler,
the diurnal / columnar / streamed traces) runs on the port's own objects
with the reference test's assertions, and once more against the reference
on identical inputs: memo entries, ``stats()``, energy, per-request arrays,
step records, routing and scale events, all with ``==``.  The port runs at
the reference's TPU v5e constants passed explicitly
(``test_torch_sim.V5E``).  ``sweep.fleet_sweep`` is held against the
reference's the same way.
"""
import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from test_torch_serving import (JTOY, TOY, assert_same_serving, configs,
                                policies, port_trace, rows, traces)
from repro.serve import policy as jpolicy
from repro.sim import engine as jengine
from repro.sim import ir as jir
from repro.sim import serving as jserving
from repro.sim.report import latency_stats as jlatency_stats
from repro.sim.report import latency_stats_array as jlatency_stats_array
from repro_torch.serve import policy as tpolicy
from repro_torch.sim import engine as tengine
from repro_torch.sim import ir as tir
from repro_torch.sim import serving as tserving
from repro_torch.sim.report import latency_stats, latency_stats_array

jsweep = importlib.import_module("repro.sim.sweep")
tsweep = importlib.import_module("repro_torch.sim.sweep")

POLICY_NAMES = ("static", "dynamic", "continuous")
CONFIG_FIELDS = [
    {},
    dict(interface="hbm", hbm_ports=0.5, host_dispatch_s=5e-6,
         datapath_scale=1.5),
    dict(interface="dma", host_threads=2),
]
ARRAYS = ("rid", "arrival_s", "prompt_len", "output_len", "first_token_s",
          "finish_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policies(max_batch=4):
    return [policies(n, max_batch=max_batch) for n in POLICY_NAMES]


def assert_same_replay(j, t):
    """Two ``ReplayResult``s, the reference's and the port's, ``==``."""
    assert t.stats() == j.stats()
    assert t.energy() == j.energy()
    for col in ARRAYS:
        a, b = getattr(t, col), getattr(j, col)
        assert a.dtype == b.dtype
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    for f in ("name", "makespan_s", "busy_s", "n_steps", "decode_steps",
              "decode_slot_steps", "prefill_tokens", "active_tokens",
              "flops", "transfer_j", "meta", "total_tokens"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.steps is None) == (j.steps is None)
    if t.steps is not None:
        assert rows(t.steps) == rows(j.steps)


def assert_same_fleet(j, t):
    """Two ``FleetResult``s, the reference's and the port's, ``==``."""
    assert t.stats() == j.stats()
    assert t.energy() == j.energy()
    for kw in (dict(ttft_slo_s=1e9, tpot_slo_s=1e9),
               dict(ttft_slo_s=0.01, tpot_slo_s=1e-4)):
        assert t.slo_attainment(**kw) == j.slo_attainment(**kw)
    for col in ARRAYS + ("replica_of",):
        a, b = getattr(t, col), getattr(j, col)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    assert rows(t.scale_events) == rows(j.scale_events)
    assert (t.name, t.makespan_s, t.busy_s, t.n_steps, t.meta,
            t.router.kind, t.cost_per_token_j()) == \
        (j.name, j.makespan_s, j.busy_s, j.n_steps, j.meta, j.router.kind,
         j.cost_per_token_j())
    assert len(t.replicas) == len(j.replicas)
    for a, b in zip(j.replicas, t.replicas):
        assert_same_replay(a, b)
    assert tserving.as_fleet_records([t]) == jserving.as_fleet_records([j])
    assert tserving.as_fleet_records([t], per_replica=True) == \
        jserving.as_fleet_records([j], per_replica=True)


def replay(jtrace, pair, config_pair=None, **kw):
    """``replay_serving`` in both packages on the same trace (a list, or
    the port's and the reference's ``TraceArrays``); the port's result."""
    jc, tc = config_pair if config_pair is not None else configs()
    jt, tt = jtrace if isinstance(jtrace, tuple) else (jtrace,
                                                       port_trace(jtrace))
    j = jserving.replay_serving(JTOY, jt, pair[0], jc, **kw)
    t = tserving.replay_serving(TOY, tt, pair[1], tc, **kw)
    assert_same_replay(j, t)
    return t


def fleet(jtrace, pair, config_pair=None, **kw):
    jc, tc = config_pair if config_pair is not None else configs()
    jt, tt = jtrace if isinstance(jtrace, tuple) else (jtrace,
                                                       port_trace(jtrace))
    j = jserving.simulate_fleet(JTOY, jt, pair[0], jc, **kw)
    tkw = dict(kw)
    if "autoscaler" in kw:
        tkw["autoscaler"] = tpolicy.QueueDepthAutoscaler(
            **dataclasses.asdict(kw["autoscaler"]))
    t = tserving.simulate_fleet(TOY, tt, pair[1], tc, **tkw)
    assert_same_fleet(j, t)
    return t


# ---------------------------------------------------------------------------
# the memo: StepCostTable == engine.chain_op_costs, bit for bit


@pytest.mark.parametrize("fields", CONFIG_FIELDS)
def test_step_cost_table_matches_chain_op_costs(fields):
    """Every (prefill tuple, decode composition) the table prices must
    reproduce the engine's per-op chain terms exactly — including on
    interfaces (dma) that take the un-fast fallback path — and the
    reference's memo entries."""
    import random
    rng = random.Random(11)
    jc, config = configs(**fields)
    table = tserving.StepCostTable(TOY, config)
    jtable = jserving.StepCostTable(JTOY, jc)
    assert table._fast == jtable._fast
    for trial in range(50):
        pf = tuple(rng.randint(1, 40)
                   for _ in range(rng.randint(0, 4)))
        dpos = tuple(rng.randint(1, 200)
                     for _ in range(rng.randint(0, 6)))
        if not pf and not dpos:
            continue
        prog = tir.from_serving_step(TOY, step=trial, prefill_lens=pf,
                                     decode_positions=dpos)
        exact = [tengine.chain_op_costs(op, config) for op in prog.ops]
        memo = table.step_entries(pf, len(dpos), sum(dpos))
        assert len(memo) == len(exact)
        for entry, terms in zip(memo, exact):
            assert entry[:4] == terms            # (host, xfer, comp, coll)
        assert table.step_entries(pf, len(dpos), sum(dpos)) == memo
        assert memo == jtable.step_entries(pf, len(dpos), sum(dpos))
    assert table.hits > 0 and 0.0 < table.hit_rate < 1.0
    assert table.misses == jtable.misses


def test_step_cost_table_signature_sufficiency():
    """The decode entry depends on positions only through (count, sum) —
    the exact claim ``ir.serving_step_signature`` documents."""
    _, config = configs()
    table = tserving.StepCostTable(TOY, config)
    a = table.step_entries((), 3, 60)
    for dpos in ((20, 20, 20), (1, 1, 58), (50, 9, 1)):
        prog = tir.from_serving_step(TOY, step=0, prefill_lens=(),
                                     decode_positions=dpos)
        exact = [tengine.chain_op_costs(op, config) for op in prog.ops]
        assert [e[:4] for e in a] == exact


def test_step_cost_table_mismatch_rejected():
    table = tserving.StepCostTable(TOY, tengine.EngineConfig())
    other = tengine.EngineConfig(hbm_ports=2.0)
    assert not table.matches(TOY, other, 2.0)
    assert table.matches(TOY, tengine.EngineConfig(), 2)
    with pytest.raises(ValueError, match="different"):
        tserving.replay_serving(TOY, tserving.poisson_trace(4, 10.0),
                                tpolicy.StaticBatching(4), other,
                                table=table)


def test_signature_helpers_round_trip():
    sig = tir.serving_step_signature((3, 5), (7, 9, 11))
    assert sig == ((3, 5), 3, 27) == jir.serving_step_signature((3, 5),
                                                                (7, 9, 11))
    pos = tir.positions_for_signature(3, 27)
    assert len(pos) == 3 and sum(pos) == 27 and min(pos) >= 1
    assert pos == jir.positions_for_signature(3, 27)
    assert tir.positions_for_signature(0, 0) == ()


# ---------------------------------------------------------------------------
# the lite replay: bit-identical to the full co-simulation


@pytest.mark.parametrize("fields", CONFIG_FIELDS[:2])
@pytest.mark.parametrize("kind", ["poisson", "bursty"])
def test_replay_bit_identical_to_simulate(kind, fields):
    """replay_serving == simulate_serving on wall/busy clocks, step
    records, per-request times, and every stats() field — all policies,
    both trace shapes; each side == the reference's."""
    jtrace, trace = traces(f"{kind}_trace", 80, 60.0, seed=4)
    jc, config = configs(**fields)
    for jp, policy in _policies():
        a = tserving.simulate_serving(TOY, trace, policy, config)
        assert_same_serving(jserving.simulate_serving(JTOY, jtrace, jp, jc),
                            a)
        b = replay(jtrace, (jp, policy), (jc, config), record_steps=True)
        assert b.busy_s == a.busy_s
        assert b.makespan_s == a.makespan_s
        assert b.n_steps == len(a.steps)
        assert b.steps == a.steps
        am = {m.rid: (m.first_token_s, m.finish_s) for m in a.requests}
        bm = {m.rid: (m.first_token_s, m.finish_s) for m in b.requests}
        assert am == bm
        assert b.stats() == a.stats()


def test_simulate_serving_memoize_toggle_identical():
    """memoize=True changes the cost of simulate_serving, not a single
    bit of its result."""
    jtrace, trace = traces("bursty_trace", 48, 90.0, seed=2)
    jc, config = configs()
    for jp, policy in _policies():
        on = tserving.simulate_serving(TOY, trace, policy, config,
                                       memoize=True)
        off = tserving.simulate_serving(TOY, trace, policy, config,
                                        memoize=False)
        assert on.busy_s == off.busy_s
        assert on.makespan_s == off.makespan_s
        assert on.stats() == off.stats()
        assert_same_serving(jserving.simulate_serving(
            JTOY, jtrace, jp, jc, memoize=False), off)


def test_replay_energy_matches_engine():
    """The replay's energy roll-up equals the engine's on the same trace
    (same terms, possibly different float summation order)."""
    jtrace, trace = traces("poisson_trace", 48, 60.0, seed=2)
    pair = policies("continuous", max_batch=4)
    jc, config = configs()
    a = tserving.simulate_serving(TOY, trace, pair[1], config)
    assert_same_serving(jserving.simulate_serving(JTOY, jtrace, pair[0], jc),
                        a)
    b = replay(jtrace, pair)
    ea, eb = a.engine.energy, b.energy()
    assert set(eb) == set(ea)
    for k in ea:
        assert eb[k] == pytest.approx(ea[k], rel=1e-9, abs=1e-18)


def test_replay_accepts_sorted_stream_and_rejects_unsorted():
    jtrace, trace = traces("poisson_trace", 24, 40.0, seed=6)
    pair = policies("continuous", max_batch=4)
    a = replay(jtrace, pair)
    b = replay((iter(jtrace), iter(trace)), pair)
    assert a.makespan_s == b.makespan_s
    bad = [tserving.Request(0, 1.0, 4, 2), tserving.Request(1, 0.5, 4, 2)]
    with pytest.raises(ValueError, match="sorted"):
        tserving.replay_serving(TOY, iter(bad), pair[1])
    with pytest.raises(ValueError, match="duplicate rid"):
        tserving.replay_serving(TOY, [tserving.Request(3, 0.0, 4, 2),
                                      tserving.Request(3, 0.5, 4, 2)],
                                pair[1])


# ---------------------------------------------------------------------------
# the fleet: routers conserve requests, N=1 degenerates to replay


def test_fleet_single_replica_is_replay():
    jtrace, _ = traces("poisson_trace", 60, 80.0, seed=9)
    for pair in _policies():
        b = replay(jtrace, pair)
        f = fleet(jtrace, pair, n_replicas=1)
        assert f.makespan_s == b.makespan_s
        assert f.busy_s == b.busy_s
        assert list(f.first_token_s) == list(b.first_token_s)
        assert list(f.finish_s) == list(b.finish_s)


@pytest.mark.parametrize("router", ["round_robin", "least_outstanding",
                                    "session_affinity"])
def test_fleet_router_conserves_requests(router):
    """Every request is routed to exactly one replica and served exactly
    once: finish times all finite, per-replica rid sets partition the
    trace."""
    jtrace, trace = traces("bursty_trace", 200, 150.0, seed=1)
    f = fleet(jtrace, policies("continuous", max_batch=4), n_replicas=3,
              router=router)
    assert np.isfinite(np.asarray(f.finish_s)).all()
    assert np.isfinite(np.asarray(f.first_token_s)).all()
    seen = sorted(int(r) for rep in f.replicas for r in rep.rid)
    assert seen == sorted(r.rid for r in trace)
    ro = np.asarray(f.replica_of)
    for rep in f.replicas:
        idx = rep.meta["replica"]
        assert int(np.count_nonzero(ro == idx)) == len(rep.rid)
    # per-request ordering invariants hold globally
    assert (np.asarray(f.first_token_s)
            >= np.asarray(f.arrival_s)).all()
    assert (np.asarray(f.finish_s)
            >= np.asarray(f.first_token_s)).all()


def test_fleet_round_robin_assignment():
    jtrace, _ = traces("poisson_trace", 12, 50.0, seed=0)
    f = fleet(jtrace, policies("continuous", max_batch=4), n_replicas=3,
              router="round_robin")
    assert list(f.replica_of) == [i % 3 for i in range(12)]


def test_fleet_session_affinity_is_sticky():
    """The affinity hash depends only on rid, so a session's requests
    always land on the same replica regardless of arrival order."""
    router = tpolicy.get_router("session_affinity")
    jrouter = jpolicy.get_router("session_affinity")
    a = router.route(42, 0, ()) % 4
    assert all(router.route(42, s, ()) % 4 == a for s in range(5))
    assert len({router.route(rid, 0, ()) % 4
                for rid in range(64)}) > 1       # and it does spread
    for name in ("round_robin", "least_outstanding", "session_affinity"):
        t, j = tpolicy.get_router(name), jpolicy.get_router(name)
        assert (t.kind, t.stateful) == (j.kind, j.stateful)
        for rid, seq, out in ((42, 3, [2, 0, 1]), (7, 0, [1, 1]),
                              (2**40, 9, [0, 3, 0, 3])):
            assert t.route(rid, seq, out) == j.route(rid, seq, out)
    assert jrouter.route(42, 0, ()) % 4 == a
    with pytest.raises(KeyError):
        tpolicy.get_router("random")


def test_fleet_stats_and_records():
    jtrace, _ = traces("diurnal_trace", 300, 400.0, seed=7)
    f = fleet(jtrace, policies("continuous", max_batch=4), n_replicas=2)
    s = f.stats()
    assert 0.0 <= s["slo_attainment"] <= 1.0
    assert s["n_requests"] == 300 and s["n_replicas"] == 2
    assert s["cost_per_token_j"] > 0.0
    assert math.isfinite(s["makespan_s"]) and s["makespan_s"] > 0.0
    # generous SLO -> everyone attains; impossible SLO -> no one does
    assert f.slo_attainment(ttft_slo_s=1e9, tpot_slo_s=1e9) == 1.0
    assert f.slo_attainment(ttft_slo_s=-1.0, tpot_slo_s=1e-12) == 0.0
    recs = tserving.as_fleet_records([f])
    assert len(recs) == 1 and recs[0]["router"] == "round_robin"
    per = tserving.as_fleet_records([f], per_replica=True)
    assert len(per) == 2
    assert all("trace_kind" in r and "rate_rps" in r for r in per)


def test_autoscaler_bounds_cooldown_and_events():
    fields = dict(min_replicas=1, max_replicas=3, scale_up_depth=4.0,
                  scale_down_depth=0.5, cooldown_s=0.1)
    scaler = tpolicy.QueueDepthAutoscaler(**fields)
    jscaler = jpolicy.QueueDepthAutoscaler(**fields)
    # pure decision logic
    assert scaler.decide(1, 10.0, 1.0, 0.99) == 0      # inside cooldown
    assert scaler.decide(1, 10.0, 1.0, 0.0) == 1
    assert scaler.decide(3, 10.0, 1.0, 0.0) == 0       # at max
    assert scaler.decide(2, 0.1, 1.0, 0.0) == -1
    assert scaler.decide(1, 0.1, 1.0, 0.0) == 0        # at min
    for args in ((1, 10.0, 1.0, 0.99), (2, 4.0, 2.0, 0.0),
                 (2, 0.5, 2.0, 0.0), (3, 2.0, 5.0, 1.0)):
        assert scaler.decide(*args) == jscaler.decide(*args)
    # end to end: a bursty overload must trigger scale-ups, stay in
    # bounds, and still serve every request exactly once
    jtrace, _ = traces("bursty_trace", 400, 300.0, seed=8)
    f = fleet(jtrace, policies("continuous", max_batch=2), n_replicas=1,
              router="least_outstanding", autoscaler=jscaler)
    assert np.isfinite(np.asarray(f.finish_s)).all()
    assert sum(len(r.rid) for r in f.replicas) == 400
    for e in f.scale_events:
        assert 1 <= e.n_replicas <= 3
        assert e.action in ("up", "down")
    ts = [e.t_s for e in f.scale_events]
    assert all(b - a >= scaler.cooldown_s - 1e-12
               for a, b in zip(ts, ts[1:]))


# ---------------------------------------------------------------------------
# traces: diurnal generator, columnar arrays, streaming I/O


def test_diurnal_trace_properties():
    _, tr = traces("diurnal_trace", 64, 100.0, seed=5)
    assert len(tr) == 64
    assert all(isinstance(r, tserving.Request) for r in tr)
    assert all(a.arrival_s <= b.arrival_s for a, b in zip(tr, tr[1:]))
    assert all(r.arrival_s >= 0.0 and r.prompt_len >= 1
               and r.output_len >= 1 for r in tr)
    assert tr == tserving.diurnal_trace(64, 100.0, seed=5)  # deterministic
    assert tr != tserving.diurnal_trace(64, 100.0, seed=6)
    assert tserving.TRACE_GENERATORS["diurnal"] is tserving.diurnal_trace
    assert set(tserving.TRACE_GENERATORS) == set(jserving.TRACE_GENERATORS)
    with pytest.raises(ValueError, match="amplitude"):
        tserving.diurnal_trace(8, 10.0, amplitude=1.5)


def test_diurnal_arrays_agree_with_list():
    jta, ta = traces("diurnal_trace", 50, 200.0, seed=3, arrays=True)
    jtl, tl = traces("diurnal_trace", 50, 200.0, seed=3)
    assert isinstance(ta, tserving.TraceArrays) and len(ta) == 50
    assert list(ta) == tl                        # same Requests, same bits
    assert ta.columns() == jta.columns()
    pair = policies("continuous", max_batch=4)
    a = replay((jta, ta), pair)
    b = replay(jtl, pair)
    assert a.makespan_s == b.makespan_s and a.busy_s == b.busy_s


def test_diurnal_rate_modulation():
    """The sinusoidal intensity rate*(1 + A*sin(2*pi*t/P)) peaks in the
    first half-period, so at amplitude 0.9 the first half of the day
    holds well over half the requests."""
    _, tr = traces("diurnal_trace", 4000, 100.0, period_s=40.0,
                   amplitude=0.9, seed=0, arrays=True)
    t = np.asarray(tr.arrival_s)
    first_half = (t < 20.0).mean()
    assert first_half > 0.65
    # flat amplitude=0 degenerates to an ordinary Poisson process
    _, flat = traces("diurnal_trace", 4000, 100.0, period_s=40.0,
                     amplitude=0.0, seed=0, arrays=True)
    tf = np.asarray(flat.arrival_s)
    assert abs((tf < 20.0).mean() - 0.5) < 0.1


def test_trace_gzip_round_trip_and_lazy_iter(tmp_path):
    jtrace, trace = traces("diurnal_trace", 40, 80.0, seed=1)
    p = tmp_path / "trace.jsonl.gz"
    tserving.save_trace(p, trace)
    assert tserving.load_trace(p) == trace       # bit-identical floats
    assert rows(jserving.load_trace(p)) == rows(trace)
    it = tserving.iter_trace(p)
    assert next(it) == trace[0]                  # lazy: partial consume OK
    assert list(it) == trace[1:]
    # a generator (no len, no indexing) feeds save_trace and replay
    p2 = tmp_path / "stream.jsonl.gz"
    tserving.save_trace(p2, (r for r in trace))
    pair = policies("continuous", max_batch=4)
    a = replay((jserving.iter_trace(p2), tserving.iter_trace(p2)), pair)
    b = replay(jtrace, pair)
    assert a.makespan_s == b.makespan_s
    assert a.stats() == b.stats()


def test_as_serving_records_uniform_columns():
    """Every record carries rate_rps/trace_kind — sweep cells filled in,
    ad-hoc runs None — so mixed-provenance tables never KeyError."""
    jtrace, trace = traces("poisson_trace", 16, 40.0, seed=0)
    pair = policies("continuous", max_batch=4)
    jc, config = configs()
    sim = tserving.simulate_serving(TOY, trace, pair[1], config)
    jsim = jserving.simulate_serving(JTOY, jtrace, pair[0], jc)
    rep = replay(jtrace, pair)
    jrep = jserving.replay_serving(JTOY, jtrace, pair[0], jc)
    recs = tserving.as_serving_records([sim, rep])
    assert recs == jserving.as_serving_records([jsim, jrep])
    keys = set(recs[0])
    for r in recs:
        assert set(r) == keys
        assert "rate_rps" in r and "trace_kind" in r
    # sim's engine makespan == replay's busy clock, bit for bit
    assert recs[0]["engine_makespan_s"] == recs[1]["engine_makespan_s"]


def test_latency_stats_array_matches_scalar():
    import random
    rng = random.Random(3)
    for n in (0, 1, 2, 7, 100):
        xs = [rng.uniform(0.0, 5.0) for _ in range(n)]
        assert latency_stats_array(xs) == latency_stats(xs)
        assert latency_stats_array(xs) == jlatency_stats_array(xs)


# ---------------------------------------------------------------------------
# sweep.fleet_sweep: the router x replica-count grid


def test_fleet_sweep_matches_reference():
    jc, tc = configs(host_dispatch_s=50e-6, hbm_ports=4)
    kw = dict(replica_counts=(1, 3), n_requests=300, rate_rps=150.0, seed=2)
    js = jsweep.fleet_sweep(JTOY, config=jc, **kw)
    ts = tsweep.fleet_sweep(TOY, config=tc, **kw)
    assert "fleet_sweep" in tsweep.__all__
    assert [(r.meta["router"], r.meta["n_replicas"]) for r in ts] == \
        [(r, n) for r in ("round_robin", "least_outstanding",
                          "session_affinity") for n in (1, 3)]
    for j, t in zip(js, ts):
        assert_same_fleet(j, t)
    # one shared memo: every cell after the first hits it
    assert ts[-1].meta["memo_hit_rate"] > ts[0].meta["memo_hit_rate"]
    pol = tpolicy.get_policy("static", max_batch=2)
    bursty = tsweep.fleet_sweep(TOY, routers=("least_outstanding",),
                                policy=pol, trace_kind="bursty", config=tc,
                                **kw)
    jbursty = jsweep.fleet_sweep(JTOY, routers=("least_outstanding",),
                                 policy=jpolicy.get_policy("static",
                                                           max_batch=2),
                                 trace_kind="bursty", config=jc, **kw)
    for j, t in zip(jbursty, bursty):
        assert_same_fleet(j, t)


# ---------------------------------------------------------------------------
# hypothesis properties


@settings(max_examples=30, deadline=None)
@given(pf=st.lists(st.integers(1, 64), max_size=5),
       dpos=st.lists(st.integers(1, 300), max_size=8))
def test_memo_matches_engine_property(pf, dpos):
    """StepCostTable == chain_op_costs == the reference's memo for ANY
    step composition."""
    if not pf and not dpos:
        return
    jc, config = configs()
    table = tserving.StepCostTable(TOY, config)
    prog = tir.from_serving_step(TOY, step=0, prefill_lens=tuple(pf),
                                 decode_positions=tuple(dpos))
    exact = [tengine.chain_op_costs(op, config) for op in prog.ops]
    memo = table.step_entries(tuple(pf), len(dpos), sum(dpos))
    assert [e[:4] for e in memo] == exact
    assert memo == jserving.StepCostTable(JTOY, jc).step_entries(
        tuple(pf), len(dpos), sum(dpos))
    jprog = jir.from_serving_step(JTOY, step=0, prefill_lens=tuple(pf),
                                  decode_positions=tuple(dpos))
    assert exact == [jengine.chain_op_costs(op, jc) for op in jprog.ops]


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 60), rate=st.floats(1.0, 400.0),
       seed=st.integers(0, 2**16), n_replicas=st.integers(1, 4),
       router=st.sampled_from(["round_robin", "least_outstanding",
                               "session_affinity"]))
def test_fleet_conservation_property(n, rate, seed, n_replicas, router):
    """For ANY trace and fleet shape, the router neither loses nor
    duplicates a request, and the port routes as the reference does."""
    jtrace, _ = traces("poisson_trace", n, rate, seed=seed)
    f = fleet(jtrace, policies("continuous", max_batch=4),
              n_replicas=n_replicas, router=router)
    assert np.isfinite(np.asarray(f.finish_s)).all()
    assert sorted(int(r) for rep in f.replicas for r in rep.rid) \
        == list(range(n))


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 48), rate=st.floats(1.0, 300.0),
       seed=st.integers(0, 2**16),
       pname=st.sampled_from(list(POLICY_NAMES)))
def test_replay_identity_property(n, rate, seed, pname):
    """For ANY poisson trace and policy, the lite replay reproduces the
    full co-simulation bit for bit, in both packages alike."""
    jtrace, trace = traces("poisson_trace", n, rate, seed=seed)
    pair = policies(pname, max_batch=4)
    jc, config = configs()
    a = tserving.simulate_serving(TOY, trace, pair[1], config)
    assert_same_serving(jserving.simulate_serving(JTOY, jtrace, pair[0], jc),
                        a)
    b = replay(jtrace, pair)
    assert (a.busy_s, a.makespan_s) == (b.busy_s, b.makespan_s)
    assert a.stats() == b.stats()


@settings(max_examples=30, deadline=None)
@given(xs=st.lists(st.floats(0.0, 1e4), max_size=64))
def test_latency_stats_array_property(xs):
    assert latency_stats_array(xs) == latency_stats(xs)
    assert latency_stats(xs) == jlatency_stats(xs)
