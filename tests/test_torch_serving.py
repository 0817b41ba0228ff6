"""The port's serving simulator held against the JAX package's, with ``==``.

Every case of ``tests/test_serving.py`` and the serving cases of
``tests/test_topology.py`` runs on the port's own objects (``ModelConfig``,
policy, trace, ``EngineConfig``) with the reference test's assertions, and
once more against the reference on identical inputs: every ``stats()``
field, every ``StepRecord``, every request's times, the chained program op
for op, the engine's result (``test_torch_sim.assert_same_result``),
``busy_s`` and the records, all with ``==``.  The port's side runs at the
reference's TPU v5e constants passed explicitly (``test_torch_sim.V5E``).

The last tests cover what only the port has: ``apps.serving``'s H100 bf16
default, ``launch.serve_batch`` in both modes on the CPU, and a simulator
that imports no torch.
"""
import dataclasses
import importlib.util
import math
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from test_torch_sim import V5E, assert_same_result
from repro.apps import serving as japps
from repro.configs.gemma_2b import FULL as JGEMMA, SMOKE as JSMOKE
from repro.core.config import ModelConfig as JModelConfig
from repro.serve import policy as jpolicy
from repro.sim import engine as jengine
from repro.sim import hw as jhw
from repro.sim import ir as jir
from repro.sim import serving as jserving
from repro.sim.report import latency_stats as jlatency_stats
from repro_torch.apps import serving as tapps
from repro_torch.configs import get_smoke_config
from repro_torch.configs.gemma_2b import FULL as TGEMMA, SMOKE as TSMOKE
from repro_torch.core.config import ModelConfig as TModelConfig
from repro_torch.launch import serve_batch
from repro_torch.launch.serve import serve
from repro_torch.serve import policy as tpolicy
from repro_torch.sim import engine as tengine
from repro_torch.sim import hw as thw
from repro_torch.sim import ir as tir
from repro_torch.sim import serving as tserving
from repro_torch.sim.report import latency_stats, percentile

ROOT = pathlib.Path(__file__).resolve().parents[1]

TOY_FIELDS = dict(name="toy", family="dense", n_layers=2, d_model=8,
                  n_heads=2, n_kv_heads=2, d_ff=16, vocab=32, head_dim=4)
JTOY = JModelConfig(**TOY_FIELDS)
TOY = TModelConfig(**TOY_FIELDS)

OP_FIELDS = ("name", "flops", "dot_flops", "bytes_in", "bytes_out", "deps",
             "phase", "device_class")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# both packages' inputs and results


def configs(**fields):
    """The reference's config and the port's at the v5e's constants."""
    return (jengine.EngineConfig(**fields),
            tengine.EngineConfig(**{**V5E, **fields}))


def policies(kind, **kw):
    return (jpolicy.get_policy(kind, **kw), tpolicy.get_policy(kind, **kw))


def rows(trace):
    return [dataclasses.astuple(r) for r in trace]


def port_trace(trace):
    """The reference's ``Request`` list as the port's, field for field."""
    return [tserving.Request(*dataclasses.astuple(r)) for r in trace]


def traces(gen, *args, **kw):
    """One generator of each package on the same arguments; the port's
    trace equals the reference's request for request."""
    j = getattr(jserving, gen)(*args, **kw)
    t = getattr(tserving, gen)(*args, **kw)
    if isinstance(t, tserving.TraceArrays):
        for col in ("arrival_s", "prompt_len", "output_len", "rid"):
            assert np.array_equal(getattr(t, col), getattr(j, col))
    else:
        assert rows(t) == rows(j)
    return j, t


def op_rows(program):
    return [tuple(getattr(op, f) for f in OP_FIELDS) for op in program.ops]


def assert_same_program(j, t):
    assert op_rows(t) == op_rows(j)
    assert (t.name, t.source, t.meta) == (j.name, j.source, j.meta)


def assert_same_serving(j, t):
    """Two ``ServingResult``s, the reference's and the port's, ``==``."""
    assert t.stats() == j.stats()
    assert rows(t.steps) == rows(j.steps)
    assert rows(t.requests) == rows(j.requests)
    assert (t.makespan_s, t.busy_s) == (j.makespan_s, j.busy_s)
    assert (t.total_tokens, t.throughput_tok_s, t.throughput_req_s,
            t.occupancy) == (j.total_tokens, j.throughput_tok_s,
                             j.throughput_req_s, j.occupancy)
    assert t.meta == j.meta
    assert_same_program(j.program, t.program)
    assert_same_result(j.engine, t.engine)
    assert t.busy_s == t.engine.makespan
    assert [(e.worker, e.name, e.start, e.duration, e.kind, e.phase)
            for e in t.wall_timeline().events] == \
        [(e.worker, e.name, e.start, e.duration, e.kind, e.phase)
         for e in j.wall_timeline().events]


def simulate(jcfg_model, tcfg_model, jtrace, policy_pair, config_pair=None,
             **kw):
    """``simulate_serving`` in both packages on the same inputs; the port's
    result (checked ``==`` against the reference's) and the reference's."""
    jc, tc = config_pair if config_pair is not None else configs()
    jp, tp = policy_pair
    j = jserving.simulate_serving(jcfg_model, jtrace, jp, jc, **kw)
    t = tserving.simulate_serving(tcfg_model, port_trace(jtrace), tp, tc,
                                  **kw)
    assert_same_serving(j, t)
    return t, j


# ---------------------------------------------------------------------------
# from_serving_step accounting (hand-computed)


def _steps(**kw):
    j, t = jir.from_serving_step(JTOY, **kw), tir.from_serving_step(TOY, **kw)
    assert_same_program(j, t)
    return t


def test_from_serving_step_accounting():
    """Byte/flop accounting of one mixed step vs the documented formulas."""
    bpp = 2.0
    prog = _steps(prefill_lens=(3, 5), decode_positions=(7, 9), step=2,
                  bytes_per_param=bpp)
    assert [op.name for op in prog.ops] == ["step2/prefill", "step2/decode"]
    pre, dec = prog.ops
    assert dec.deps == ("step2/prefill",)

    n_active = float(TOY.active_param_count())
    kv_dim = TOY.n_kv_heads * TOY.resolved_head_dim        # 2 * 4 = 8
    n_attn = TOY.n_layers                                  # 2
    assert kv_dim == 8 and n_attn == 2
    weight_bytes = n_active * bpp
    kv_entry = kv_dim * n_attn * bpp                       # 32 B per token

    # prefill: 3+5 tokens dense + causal attention 3*2/2 + 5*4/2 = 3 + 10
    assert pre.flops == 2.0 * n_active * 8 + 4.0 * n_attn * kv_dim * 13
    assert pre.dot_flops == pre.flops
    assert pre.bytes_in == weight_bytes          # weights once, on first op
    assert pre.bytes_out == kv_entry * 8         # one KV entry per token

    # decode: 2 slots at positions 7 and 9
    assert dec.flops == 2.0 * n_active * 2 + 4.0 * n_attn * kv_dim * 16
    assert dec.bytes_in == 2.0 * n_attn * kv_dim * 16 * bpp   # KV re-read
    assert dec.bytes_out == kv_entry * 2


def test_from_serving_step_decode_only_charges_weights():
    prog = _steps(decode_positions=(4,), step=0)
    (dec,) = prog.ops
    n_active = float(TOY.active_param_count())
    assert dec.deps == ()
    assert dec.bytes_in == n_active * 2.0 + 2.0 * 2 * 8 * 4 * 2.0
    # and matches the from_decode convention at the same position
    tok = tir.from_decode(TOY, n_tokens=1, seq_len=4, ops_per_token=1).ops[0]
    assert dec.flops == tok.flops
    assert dec.bytes_in == tok.bytes_in
    assert dec.bytes_out == tok.bytes_out


def test_from_serving_step_empty():
    assert len(_steps().ops) == 0


@pytest.mark.parametrize("arch", ["gemma3_1b", "falcon_mamba_7b",
                                  "phi3_mini_3_8b"])
def test_from_serving_step_on_the_served_models(arch):
    """The three models the card serves, FULL, lowered alike."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    kw = dict(prefill_lens=(1024, 1024, 7), decode_positions=(1030, 1),
              step=5)
    assert_same_program(jir.from_serving_step(jget(arch), **kw),
                        tir.from_serving_step(tget(arch), **kw))


# ---------------------------------------------------------------------------
# scheduler: hand-checked 2-request trace


def test_two_request_static_schedule():
    """2 simultaneous requests, static max_batch=2, outputs (2, 3):
    prefill step + 2 decode steps; the short request pads the last one."""
    trace = [jserving.Request(0, 0.0, prompt_len=4, output_len=2),
             jserving.Request(1, 0.0, prompt_len=6, output_len=3)]
    res, _ = simulate(JTOY, TOY, trace, policies("static", max_batch=2))
    assert isinstance(res.policy, tpolicy.StaticBatching)
    assert [op.name for op in res.program.ops] == \
        ["step0/prefill", "step1/decode", "step2/decode"]
    assert [(s.n_prefill, s.n_decode, s.n_active) for s in res.steps] == \
        [(2, 0, 0), (0, 2, 2), (0, 2, 1)]          # last step: 1 padded slot
    # positions advance batch-wide from the prompt lengths
    assert res.program.ops[1].flops == \
        2.0 * TOY.active_param_count() * 2 + 4.0 * 2 * 8 * (4 + 6)
    assert res.program.ops[2].flops == \
        2.0 * TOY.active_param_count() * 2 + 4.0 * 2 * 8 * (5 + 7)
    a, b = res.requests
    assert a.first_token_s == b.first_token_s == res.steps[0].end_s
    assert a.finish_s == res.steps[1].end_s
    assert b.finish_s == res.steps[2].end_s == res.makespan_s
    assert res.total_tokens == 2 + 3
    assert res.occupancy == pytest.approx((2 + 1) / (2 * 2))


def test_serving_determinism_bit_identical():
    jtrace, trace = traces("poisson_trace", 24, 40.0, seed=7)
    for kind, kw in (("static", {}), ("dynamic", {"max_wait_s": 0.02}),
                     ("continuous", {})):
        pair = policies(kind, max_batch=4, **kw)
        a, _ = simulate(JTOY, TOY, jtrace, pair)
        b = tserving.simulate_serving(TOY, trace, pair[1],
                                      tengine.EngineConfig(**V5E))
        assert a.engine.makespan == b.engine.makespan
        assert a.engine.timeline.events == b.engine.timeline.events
        assert a.engine.energy == b.engine.energy
        assert a.makespan_s == b.makespan_s
        assert a.requests == b.requests
        assert a.steps == b.steps


@pytest.mark.parametrize("fields", [
    {},
    dict(interface="acp", host_dispatch_s=1e-6),
    dict(interface="dma", hbm_ports=2, host_bw=20e9),
])
def test_scheduler_clock_matches_engine_bitwise(fields):
    """The scheduler's busy accumulation IS the engine's chain prefix sum."""
    jtrace, _ = traces("poisson_trace", 16, 100.0, seed=3)
    for kind in ("static", "dynamic", "continuous"):
        res, _ = simulate(JTOY, TOY, jtrace, policies(kind, max_batch=4),
                          configs(**fields))
        assert tengine.prepare(res.program).is_chain
        assert res.busy_s == res.engine.makespan
        assert res.makespan_s >= res.busy_s


# ---------------------------------------------------------------------------
# policy edge cases


def test_empty_trace():
    for kind in ("static", "dynamic", "continuous"):
        res, _ = simulate(JTOY, TOY, [], policies(kind))
        assert res.steps == [] and res.requests == []
        assert len(res.program.ops) == 0
        assert res.makespan_s == 0.0 and res.engine.makespan == 0.0
        assert res.throughput_tok_s == 0.0 and res.occupancy == 0.0
        assert res.stats()["n_steps"] == 0


def test_dynamic_max_wait_expiry_launches_partial_batch():
    """A lone request must not wait forever for a full batch: the max-wait
    deadline launches a 1-request batch; the later request forms its own."""
    trace = [jserving.Request(0, 0.0, 4, 2), jserving.Request(1, 1.0, 4, 2)]
    res, _ = simulate(JTOY, TOY, trace, policies("dynamic", max_batch=8,
                                                 max_wait_s=0.01))
    prefills = [s for s in res.steps if s.n_prefill]
    assert [s.n_prefill for s in prefills] == [1, 1]
    assert prefills[0].start_s == pytest.approx(0.01)
    assert prefills[1].start_s >= 1.0
    # static with the same trace would batch them together at end-of-trace
    res_static, _ = simulate(JTOY, TOY, trace,
                             policies("static", max_batch=8))
    assert [s.n_prefill for s in res_static.steps if s.n_prefill] == [2]


def test_continuous_evicts_at_end_of_output_and_reuses_slot():
    """max_batch=1: the second request can only start once the first's
    output completes (eviction frees the slot)."""
    trace = [jserving.Request(0, 0.0, 4, 5), jserving.Request(1, 0.0, 4, 3)]
    res, _ = simulate(JTOY, TOY, trace, policies("continuous", max_batch=1))
    a, b = res.requests
    assert b.first_token_s >= a.finish_s
    assert res.total_tokens == 8
    # every decode step carries exactly the one live slot
    assert all(s.n_decode == 1 for s in res.steps if s.n_decode)


def test_continuous_admits_into_freed_slots_mid_flight():
    trace = [jserving.Request(0, 0.0, 4, 2), jserving.Request(1, 0.0, 4, 8),
             jserving.Request(2, 0.0, 4, 8)]
    res, _ = simulate(JTOY, TOY, trace, policies("continuous", max_batch=2))
    c = res.requests[2]
    a = res.requests[0]
    # request 2 was admitted right after request 0 finished, well before
    # request 1 (which still had output budget) released its slot
    assert a.finish_s <= c.first_token_s < res.requests[1].finish_s


def test_static_holds_padded_slots_until_batch_drains():
    trace = [jserving.Request(0, 0.0, 4, 1), jserving.Request(1, 0.0, 4, 6)]
    res, _ = simulate(JTOY, TOY, trace, policies("static", max_batch=2))
    # output_len=1 finishes at prefill; the padded slot still occupies the
    # batch for all 5 decode steps
    decode_steps = [s for s in res.steps if s.n_decode]
    assert all(s.n_decode == 2 for s in decode_steps)
    assert [s.n_active for s in decode_steps] == [1] * 5
    assert res.requests[0].finish_s == res.requests[0].first_token_s
    assert res.requests[0].tpot_s == 0.0


# ---------------------------------------------------------------------------
# the end-to-end claim + the sweep grid


def test_continuous_beats_static_at_saturation():
    """Acceptance: at an arrival rate that saturates the server,
    continuous batching yields strictly higher simulated throughput."""
    jtrace, _ = traces("poisson_trace", 48, 500.0, seed=0)
    cont, _ = simulate(JGEMMA, TGEMMA, jtrace,
                       policies("continuous", max_batch=8))
    stat, _ = simulate(JGEMMA, TGEMMA, jtrace,
                       policies("static", max_batch=8))
    assert cont.throughput_tok_s > stat.throughput_tok_s
    assert cont.occupancy > stat.occupancy
    # and first tokens come back sooner under iteration-level admission
    assert cont.stats()["ttft_p50"] < stat.stats()["ttft_p50"]


def test_serving_sweep_grid_and_records():
    jps = [jpolicy.StaticBatching(4), jpolicy.ContinuousBatching(4)]
    tps = [tpolicy.StaticBatching(4), tpolicy.ContinuousBatching(4)]
    jc, tc = configs()
    jres = jserving.serving_sweep(JTOY, jps, [50.0, 200.0], n_requests=12,
                                  seed=1, config=jc)
    results = tserving.serving_sweep(TOY, tps, [50.0, 200.0], n_requests=12,
                                     seed=1, config=tc)
    assert len(results) == 4
    assert [r.meta["rate_rps"] for r in results] == [50.0, 50.0,
                                                     200.0, 200.0]
    for j, t in zip(jres, results):
        assert_same_serving(j, t)
    recs = tserving.as_serving_records(results)
    assert recs == jserving.as_serving_records(jres)
    assert {r["policy"] for r in recs} == {"static", "continuous"}
    for row in recs:
        assert set(row) >= {"rate_rps", "throughput_tok_s", "ttft_p50",
                            "ttft_p99", "tpot_p50", "occupancy",
                            "makespan_s", "engine_makespan_s"}


# ---------------------------------------------------------------------------
# traces, policies, stats helpers


def test_trace_generators_deterministic_and_sorted():
    _, a = traces("poisson_trace", 32, 25.0, seed=5)
    assert a == tserving.poisson_trace(32, 25.0, seed=5)
    assert a != tserving.poisson_trace(32, 25.0, seed=6)
    assert all(x.arrival_s <= y.arrival_s for x, y in zip(a, a[1:]))
    _, b = traces("bursty_trace", 32, 25.0, seed=5)
    assert b == tserving.bursty_trace(32, 25.0, seed=5)
    assert all(r.prompt_len >= 1 and r.output_len >= 1 for r in a + b)


def test_trace_round_trip(tmp_path):
    jtrace, trace = traces("poisson_trace", 8, 10.0, seed=2)
    p = tmp_path / "trace.jsonl"
    tserving.save_trace(p, trace)
    assert tserving.load_trace(p) == trace
    # the file is the reference's record format, byte for byte
    jserving.save_trace(tmp_path / "ref.jsonl", jtrace)
    assert p.read_bytes() == (tmp_path / "ref.jsonl").read_bytes()
    assert rows(jserving.load_trace(p)) == rows(trace)
    # JSON-array form loads too
    q = tmp_path / "trace.json"
    q.write_text("[" + ",".join(
        '{"arrival_s": %r, "prompt_len": %d, "output_len": %d}'
        % (r.arrival_s, r.prompt_len, r.output_len) for r in trace) + "]")
    loaded = tserving.load_trace(q)
    assert [(r.arrival_s, r.prompt_len, r.output_len) for r in loaded] == \
        [(r.arrival_s, r.prompt_len, r.output_len) for r in trace]
    assert rows(loaded) == rows(jserving.load_trace(q))
    assert tserving.trace_from_records([{"arrival_s": 1.5, "prompt_len": 0,
                                         "output_len": 0}]) == \
        [tserving.Request(0, 1.5, 1, 1)]        # lengths clamp to >= 1


def test_duplicate_rids_rejected():
    """Metrics are keyed on rid — a duplicate must fail loudly, not
    silently collapse two requests into one latency record."""
    rec = {"rid": 5, "arrival_s": 0.0, "prompt_len": 4, "output_len": 2}
    with pytest.raises(ValueError, match="duplicate rid"):
        tserving.trace_from_records([rec, dict(rec, arrival_s=0.5)])
    with pytest.raises(ValueError, match="duplicate rid"):
        tserving.simulate_serving(TOY, [tserving.Request(5, 0.0, 4, 2),
                                        tserving.Request(5, 0.5, 4, 2)],
                                  tpolicy.StaticBatching(max_batch=2))


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 48), rate=st.floats(0.5, 500.0),
       seed=st.integers(0, 2**16), kind=st.sampled_from(["poisson",
                                                         "bursty"]))
def test_trace_generator_properties(n, rate, seed, kind):
    """Arrivals are sorted and non-negative, lengths are >= 1, and the
    generators are pure functions of their arguments — for ANY
    (n, rate, seed); and the port's trace is the reference's."""
    _, trace = traces(f"{kind}_trace", n, rate, seed=seed)
    gen = tserving.TRACE_GENERATORS[kind]
    assert len(trace) == n
    assert all(r.arrival_s >= 0.0 for r in trace)
    assert all(x.arrival_s <= y.arrival_s for x, y in zip(trace, trace[1:]))
    assert all(r.prompt_len >= 1 and r.output_len >= 1 for r in trace)
    assert [r.rid for r in trace] == list(range(n))
    assert trace == gen(n, rate, seed=seed)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 32), rate=st.floats(1.0, 300.0),
       seed=st.integers(0, 2**16))
def test_trace_round_trip_property(n, rate, seed):
    """save_trace -> load_trace is the identity, bit for bit, through
    BOTH record formats (JSON-lines and a JSON array), and the port reads
    what the reference writes."""
    import json
    import tempfile
    jtrace, trace = traces("poisson_trace", n, rate, seed=seed)
    with tempfile.TemporaryDirectory() as d:
        p = f"{d}/trace.jsonl"
        tserving.save_trace(p, trace)
        assert tserving.load_trace(p) == trace     # JSONL, bit-identical
        q = f"{d}/trace.json"
        with open(p) as f:
            records = [json.loads(ln) for ln in f]
        with open(q, "w") as f:
            json.dump(records, f)
        assert tserving.load_trace(q) == trace     # JSON array, same bits
        r = f"{d}/ref.jsonl"
        jserving.save_trace(r, jtrace)
        assert tserving.load_trace(r) == trace


def test_get_policy_registry():
    assert tpolicy.get_policy("dynamic", max_batch=16,
                              max_wait_s=0.5).max_wait_s == 0.5
    with pytest.raises(KeyError):
        tpolicy.get_policy("clairvoyant")
    for name in ("static", "dynamic", "continuous"):
        j, t = policies(name, max_batch=3)
        assert (t.kind, t.max_batch) == (j.kind, j.max_batch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for args in ((0, 0.0, False), (3, 0.0, False), (1, 0.02, False),
                     (1, 0.0, True)):
            assert t.ready(*args) == j.ready(*args)
        assert t.launch_deadline_s(1.25) == j.launch_deadline_s(1.25)


def test_percentile_and_latency_stats():
    xs = [1.0, 2.0, 3.0, 4.0]
    assert percentile(xs, 0) == 1.0
    assert percentile(xs, 100) == 4.0
    assert percentile(xs, 50) == pytest.approx(2.5)
    assert percentile(xs, 99) == pytest.approx(
        float(np.percentile(xs, 99)))
    s = latency_stats(xs)
    assert s == jlatency_stats(xs)
    assert s["n"] == 4 and s["mean"] == 2.5 and s["max"] == 4.0
    empty = latency_stats([])
    assert empty["n"] == 0 and empty["p99"] == 0.0
    assert not any(math.isnan(v) for v in empty.values())


# ---------------------------------------------------------------------------
# the serving cases of tests/test_topology.py

CPU_PEAK = 1e10
HBM_BW = 1e9


def test_serving_cosimulation_matches_on_heterogeneous_topology():
    """busy_s == engine.makespan stays bit-exact when the serving config
    carries a heterogeneous (cpu + 2 uniform accel) topology."""
    def soc(hw):
        return hw.SoCTopology(
            devices=(hw.Device("cpu0", kind="cpu", peak_flops=CPU_PEAK),
                     hw.Device("acc0"), hw.Device("acc1")),
            links=(hw.Link("hbm", ports=4.0),))
    fields = dict(interface="hbm", host_dispatch_s=1e-6)
    jc, tc = configs(topology=soc(jhw), **fields)
    tc = dataclasses.replace(tc, topology=soc(thw))
    jtrace, _ = traces("poisson_trace", 12, 200.0, seed=3)
    res, _ = simulate(JSMOKE, TSMOKE, jtrace,
                      policies("continuous", max_batch=4), (jc, tc))
    assert res.busy_s == res.engine.makespan
    assert res.makespan_s >= res.busy_s

    # a mixed-signature accelerator pool would silently break that
    # invariant (the event loop load-balances across devices with
    # different costs) -> simulate_serving rejects it up front
    mixed = thw.SoCTopology(
        devices=(thw.Device("acc0", peak_flops=1e12),
                 thw.Device("acc1", peak_flops=2e12)),
        links=(thw.Link("hbm", ports=4.0),))
    with pytest.raises(ValueError, match="uniform accelerator pool"):
        tserving.simulate_serving(TSMOKE, port_trace(jtrace),
                                  tpolicy.ContinuousBatching(max_batch=4),
                                  dataclasses.replace(tc, topology=mixed))


def test_uniform_class_params_detects_mixed_pools():
    """The precondition the serving co-simulation relies on: a pool is
    uniform only when every candidate device of the class shares one cost
    signature AND one link — the same verdict in both packages."""
    def cases(hw, engine):
        uniform = hw.SoCTopology(
            devices=(hw.Device("acc0", peak_flops=2e12),
                     hw.Device("acc1", peak_flops=2e12)),
            links=(hw.Link("hbm", ports=2.0),))
        mixed_peak = hw.SoCTopology(
            devices=(hw.Device("acc0", peak_flops=1e12),
                     hw.Device("acc1", peak_flops=2e12)))
        split_links = hw.SoCTopology(
            devices=(hw.Device("acc0", link="m0"),
                     hw.Device("acc1", link="m1")),
            links=(hw.Link("m0", ports=1.0), hw.Link("m1", ports=1.0)))
        mixed_iface = hw.SoCTopology(
            devices=(hw.Device("acc0", interface="acp"), hw.Device("acc1")))
        return [engine.uniform_class_params(engine.EngineConfig(**kw),
                                            "accel")
                for kw in (dict(topology=uniform), dict(n_workers=8),
                           dict(topology=mixed_peak),
                           dict(topology=split_links),
                           dict(interface="hbm", topology=mixed_iface))]
    got = cases(thw, tengine)
    assert got == [True, True, False, False, False]
    assert got == cases(jhw, jengine)


def test_mixed_pool_serving_error_is_actionable():
    """The clear-error path: a mixed accelerator pool is rejected up
    front with a message that names the problem and the fix surface,
    the reference's message word for word."""
    msgs = []
    for hw, engine, serving, policy, model in (
            (jhw, jengine, jserving, jpolicy, JSMOKE),
            (thw, tengine, tserving, tpolicy, TSMOKE)):
        mixed = hw.SoCTopology(
            devices=(hw.Device("acc0", hbm_bw=1e9),
                     hw.Device("acc1", hbm_bw=2e9)))
        with pytest.raises(ValueError) as ei:
            serving.simulate_serving(model,
                                     serving.poisson_trace(4, 100.0, seed=0),
                                     policy.ContinuousBatching(max_batch=2),
                                     engine.EngineConfig(topology=mixed))
        msgs.append(str(ei.value))
    msg = msgs[1]
    assert "uniform accelerator pool" in msg
    assert "cost signature" in msg and "chain_op_costs" in msg
    assert msg == msgs[0]


def test_uniform_override_pool_serving_busy_equals_makespan_bitwise():
    """A pool that overrides device parameters UNIFORMLY (every accel at
    the same non-default peak/bandwidth, one shared link) still satisfies
    busy_s == engine.makespan bit for bit — the chain_op_costs pricing
    path equals the engine's charge on every op."""
    def soc(hw):
        return hw.SoCTopology(
            devices=(hw.Device("cpu0", kind="cpu", peak_flops=CPU_PEAK),
                     hw.Device("acc0", peak_flops=2e12, hbm_bw=2e9),
                     hw.Device("acc1", peak_flops=2e12, hbm_bw=2e9)),
            links=(hw.Link("hbm", ports=2.0),))
    fields = dict(interface="hbm", hbm_bw=HBM_BW, host_dispatch_s=1e-6)
    jc, tc = configs(topology=soc(jhw), **fields)
    tc = dataclasses.replace(tc, topology=soc(thw))
    assert tengine.uniform_class_params(tc, "accel")
    jtrace, _ = traces("poisson_trace", 10, 150.0, seed=11)
    for kind in ("static", "dynamic", "continuous"):
        res, _ = simulate(JSMOKE, TSMOKE, jtrace,
                          policies(kind, max_batch=4), (jc, tc))
        assert res.busy_s == res.engine.makespan
        assert res.makespan_s >= res.busy_s


# ---------------------------------------------------------------------------
# apps.serving: the reference at v5e constants, and the H100 bf16 default


@pytest.mark.parametrize("kind,trace_kind", [("continuous", "poisson"),
                                             ("static", "bursty"),
                                             ("dynamic", "diurnal")])
def test_serve_trace_matches_reference(kind, trace_kind):
    jc, tc = configs()
    kw = dict(rate_rps=80.0, n_requests=24, max_batch=4,
              trace_kind=trace_kind, seed=2, smoke=True)
    j = japps.serve_trace("gemma3_1b", kind, config=jc, **kw)
    t = tapps.serve_trace("gemma3_1b", kind, config=tc, **kw)
    assert t.program.name == "gemma3_1b/serve"
    assert_same_serving(j, t)


@pytest.mark.parametrize("router", ["round_robin", "least_outstanding"])
def test_serve_fleet_matches_reference(router):
    from test_torch_fleet import assert_same_fleet
    jc, tc = configs()
    kw = dict(n_replicas=3, router=router, rate_rps=300.0, n_requests=200,
              max_batch=4, seed=1, smoke=True)
    j = japps.serve_fleet("gemma_2b", "continuous", config=jc, **kw)
    t = tapps.serve_fleet("gemma_2b", "continuous", config=tc, **kw)
    assert t.name == "gemma_2b/fleet"
    assert_same_fleet(j, t)


def test_serving_app_defaults_to_the_h100_bf16_peak():
    """With no config, serve_trace and serve_fleet price on one H100 at its
    bf16 peak; simulate_serving keeps the engine's plain EngineConfig()."""
    bf16 = tengine.EngineConfig(peak_flops=thw.PEAK_FLOPS_BF16)
    assert tapps.default_config() == bf16
    assert bf16.peak_flops == 989e12 and thw.PEAK_FLOPS == 67e12
    kw = dict(n_requests=16, max_batch=4, smoke=True)
    res = tapps.serve_trace("gemma3_1b", "static", **kw)
    assert res.config == bf16
    assert res.stats() == tapps.serve_trace("gemma3_1b", "static",
                                            config=bf16, **kw).stats()
    # the float32 rate prices the same steps slower
    f32 = tapps.serve_trace("gemma3_1b", "static",
                            config=tengine.EngineConfig(), **kw)
    assert f32.busy_s > res.busy_s
    fleet = tapps.serve_fleet("gemma3_1b", n_requests=40, smoke=True)
    assert fleet.config == bf16
    plain = tserving.simulate_serving(
        TSMOKE, tserving.poisson_trace(4, 10.0), tpolicy.StaticBatching(2))
    assert plain.config == tengine.EngineConfig()


# ---------------------------------------------------------------------------
# launch.serve_batch: both modes on the CPU


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_serve_batch", ROOT / "examples" / "serve_batch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("policy,full", [("static", False),
                                         ("continuous", False),
                                         ("dynamic", True)])
def test_run_simulated_prints_the_reference_summary(policy, full, capsys):
    """At the v5e's constants the port's summary is the reference
    example's, line for line (the ASCII timeline included)."""
    args = types.SimpleNamespace(arch="gemma3_1b", policy=policy, rate=60.0,
                                 requests=20, batch=4, seed=0, full=full)
    _reference_example().run_simulated(args)
    expect = capsys.readouterr().out
    lines = []
    res = serve_batch.run_simulated(
        "gemma3_1b", policy, rate=60.0, requests=20, batch=4, seed=0,
        full=full, config=tengine.EngineConfig(**V5E), log=lines.append)
    assert "\n".join(lines) + "\n" == expect
    assert len(lines) == 6 and res.stats()["n_requests"] == 20


def test_serve_batch_cli_simulate_prices_on_the_h100(capsys):
    serve_batch.main(["--simulate", "--requests", "12", "--device", "cpu"])
    out = capsys.readouterr().out
    res = tapps.serve_trace("gemma3_1b", "static", n_requests=12,
                            max_batch=4, smoke=True)
    s = res.stats()
    assert f"{s['n_steps']:.0f} scheduler steps" in out
    assert f"throughput {s['throughput_tok_s']:.0f} tok/s" in out


@pytest.mark.parametrize("arch", ["gemma3_1b", "falcon_mamba_7b"])
def test_run_measured_on_cpu_matches_serve(arch):
    """One batch of ``max_batch`` prompts through the port's prefill and
    decode steps on the CPU: the tokens ``launch.serve.serve`` generates
    for the same seed."""
    cfg = get_smoke_config(arch)
    out = serve_batch.run_measured(
        cfg, tpolicy.StaticBatching(max_batch=3), prompt_len=20, tokens=5,
        device="cpu", log=lambda *a: None)
    ref = serve(cfg, requests=3, batch=3, prompt_len=20, max_new=5,
                device="cpu", log=lambda *a: None)
    assert out["batch"] == 3 and out["finite"]
    assert out["tokens"].shape == (3, 5)
    np.testing.assert_array_equal(out["tokens"], ref["tokens"][0])
    assert out["logits"].shape == (3, cfg.vocab)
    np.testing.assert_array_equal(out["tokens"][:, 0],
                                  out["logits"].float().argmax(-1).numpy())


def test_serve_batch_cli_measured_on_cpu(capsys):
    serve_batch.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                      "12", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "prefill 2x12" in out and "decoded 2 steps" in out


def test_simulator_imports_no_torch():
    """The serving simulator, its policies and the serving app load numpy
    and the standard library only: no torch, no jax, no reference."""
    code = ("import sys\n"
            "import repro_torch.sim.serving, repro_torch.serve.policy\n"
            "import repro_torch.apps.serving, repro_torch.sim\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
