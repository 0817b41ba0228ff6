"""The port's training simulator held against the JAX package's, with ``==``.

Every case of ``tests/test_training.py`` but the pipeline's
``stage_layer_slices`` (distribution, not ported) runs on the port's own
objects (``ModelConfig``, ``EngineConfig``, ``SoCTopology``) with the
reference test's assertions, and once more against the reference on
identical inputs: the lowered ops op for op, and every field of each
``TrainingResult`` (the program, the engine's result through
``test_torch_sim.assert_same_result``, the step time, the per-stage busy
seconds and utilizations, the bubble, the config, the meta and
``stats()``), all with ``==``.  The port's side runs at the reference's
TPU v5e constants passed explicitly (``test_torch_sim.V5E``).

The last tests cover what only the port has: the launcher's dry run
priced on one H100 at its bf16 peak (and at the v5e's, line for line
against the reference's), its CLI, and a training simulator that imports
no torch.
"""
import dataclasses
import importlib
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from test_torch_sim import V5E, assert_same_result
from repro.core.config import ModelConfig as JModelConfig
from repro.sim import engine as jengine
from repro.sim import hw as jhw
from repro.sim import ir as jir
from repro.sim import training as jtraining
from repro_torch.apps.serving import default_config
from repro_torch.core.config import ModelConfig
from repro_torch.launch import train as tlaunch
from repro_torch.sim import engine, hw, ir
from repro_torch.sim.hw import Device, Link, SoCTopology
from repro_torch.sim.ir import (OPTIMIZER_FLOPS_PER_PARAM, from_training_step,
                                partition_stages)
from repro_torch.sim.sweep import as_training_records, training_sweep
from repro_torch.sim.training import (SCHEDULES, bubble_bound, schedule_order,
                                      simulate_training)

# the package re-exports the sweep() function under the module's name
jsweep = importlib.import_module("repro.sim.sweep")

ROOT = pathlib.Path(__file__).resolve().parents[1]

# 16 layers: divisible by every stage count in the sweeps below, so the
# homogeneous-stage premises of the acceptance invariants hold exactly
TOY_FIELDS = dict(name="toy16", family="dense", n_layers=16, d_model=64,
                  n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, head_dim=16)
TOY = ModelConfig(**TOY_FIELDS)
JTOY = JModelConfig(**TOY_FIELDS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_pair(**fields):
    """The reference's config and the port's at the v5e's constants."""
    return (jengine.EngineConfig(**fields),
            engine.EngineConfig(**{**V5E, **fields}))


def tcfg(**fields):
    return engine.EngineConfig(**{**V5E, **fields})


def assert_same_ops(jprog, tprog):
    assert [dataclasses.astuple(op) for op in tprog.ops] == \
        [dataclasses.astuple(op) for op in jprog.ops]
    assert (tprog.name, tprog.source, tprog.meta) == \
        (jprog.name, jprog.source, jprog.meta)


def assert_same_training(j, t):
    """Every field of two ``TrainingResult``s, the reference's and the
    port's, ``==``."""
    assert_same_ops(j.program, t.program)
    assert_same_result(j.engine, t.engine)
    for f in ("schedule", "n_stages", "n_microbatches", "step_time_s",
              "tokens", "per_stage_busy_s", "per_stage_utilization",
              "bubble_fraction", "bubble_bound", "meta"):
        assert getattr(t, f) == getattr(j, f), f
    assert dataclasses.astuple(t.config) == dataclasses.astuple(j.config)
    assert t.tokens_per_s == j.tokens_per_s
    assert t.stats() == j.stats()


def both_training(jconfig, tconfig, cfg=TOY, jcfg=JTOY, **kw):
    """One simulated step through each package; asserts them equal and
    returns the port's."""
    j = jtraining.simulate_training(jcfg, config=jconfig, **kw)
    t = simulate_training(cfg, config=tconfig, **kw)
    assert_same_training(j, t)
    return t


# ---------------------------------------------------------------------------
# from_training_step accounting (hand-computed)


def test_from_training_step_accounting():
    """Every term of the fwd/bwd/reduce/update chain vs the documented
    formulas, and the reference's ops op for op."""
    bpp, bpa, obp = 2.0, 2.0, 12.0
    seq, batch, dp = 128, 4, 4
    kw = dict(seq_len=seq, batch=batch, bytes_per_param=bpp,
              bytes_per_act=bpa, optimizer_bytes_per_param=obp,
              dp_degree=dp)
    prog = from_training_step(TOY, **kw)
    assert_same_ops(jir.from_training_step(JTOY, **kw), prog)
    assert [op.name for op in prog.ops] == \
        ["train/fwd", "train/bwd", "train/reduce", "train/update"]
    fwd, bwd, red, upd = prog.ops
    assert bwd.deps == ("train/fwd",)
    assert red.deps == ("train/bwd",)
    assert upd.deps == ("train/reduce",)

    n_active = float(TOY.active_param_count())
    n_full = float(TOY.param_count())
    kv_dim = TOY.n_kv_heads * TOY.resolved_head_dim
    tokens = float(batch * seq)
    attn = 4.0 * TOY.n_layers * kv_dim * (seq * (seq - 1) // 2) * batch
    fwd_flops = 2.0 * n_active * tokens + attn
    act_bytes = TOY.n_layers * TOY.d_model * tokens * bpa
    weight_bytes = n_active * bpp
    grad_bytes = n_active * bpp

    assert fwd.flops == fwd_flops and fwd.dot_flops == fwd_flops
    assert fwd.bytes_in == weight_bytes
    assert fwd.bytes_out == act_bytes                  # stored activations
    # backward: 2x forward flops, weights re-streamed + activations re-read
    assert bwd.flops == 2.0 * fwd_flops
    assert bwd.bytes_in == weight_bytes + act_bytes
    assert bwd.bytes_out == grad_bytes
    # DP all-reduce: operand-sum metric + ring wire bytes
    assert red.collective_bytes == grad_bytes
    assert red.wire_bytes == 2.0 * (dp - 1) / dp * grad_bytes
    # optimizer: full (not active) params, state in and out
    assert upd.flops == OPTIMIZER_FLOPS_PER_PARAM * n_full
    assert upd.bytes_in == grad_bytes + n_full * obp
    assert upd.bytes_out == n_full * obp + weight_bytes
    assert (ir.OPTIMIZER_FLOPS_PER_PARAM, ir.BWD_FLOPS_MULT) == \
        (jir.OPTIMIZER_FLOPS_PER_PARAM, jir.BWD_FLOPS_MULT)


def test_from_training_step_no_reduce_without_dp():
    prog = from_training_step(TOY, seq_len=64, batch=2)
    assert_same_ops(jir.from_training_step(JTOY, seq_len=64, batch=2), prog)
    assert [op.name for op in prog.ops] == \
        ["train/fwd", "train/bwd", "train/update"]
    assert engine.prepare(prog).is_chain


def test_from_training_step_stage_shares_sum_to_whole():
    """Per-stage shares over a balanced partition recompose the flat
    step (to float accumulation tolerance); each stage op for op."""
    flat = from_training_step(TOY, seq_len=128, batch=4)
    for p in (2, 4, 8):
        stages = [from_training_step(TOY, seq_len=128, batch=4,
                                     stage=s, n_stages=p)
                  for s in range(p)]
        for s, prog in enumerate(stages):
            assert_same_ops(jir.from_training_step(
                JTOY, seq_len=128, batch=4, stage=s, n_stages=p), prog)
        for attr in ("flops", "bytes_in", "bytes_out"):
            assert math.fsum(s.total(attr) for s in stages) == \
                pytest.approx(flat.total(attr), rel=1e-12)
    # uneven split still covers every layer
    assert partition_stages(18, 4) == (5, 5, 4, 4)
    assert sum(partition_stages(18, 4)) == 18
    for n, p in ((16, 4), (22, 8), (7, 7), (27, 5)):
        assert partition_stages(n, p) == jir.partition_stages(n, p)


def test_from_training_step_errors():
    with pytest.raises(ValueError, match="stage index required"):
        from_training_step(TOY, n_stages=4)
    with pytest.raises(ValueError, match="out of range"):
        from_training_step(TOY, stage=4, n_stages=4)
    with pytest.raises(ValueError, match="every stage needs"):
        partition_stages(2, 4)
    with pytest.raises(ValueError, match="n_stages"):
        partition_stages(8, 0)


# ---------------------------------------------------------------------------
# schedule orders


def test_schedule_orders_cover_every_microbatch():
    assert SCHEDULES == jtraining.SCHEDULES
    for sched in SCHEDULES:
        for p in (1, 2, 4):
            for m in (1, 3, 8):
                for s in range(p):
                    order = schedule_order(sched, s, p, m)
                    assert order == jtraining.schedule_order(sched, s, p, m)
                    assert sorted(x for k, x in order if k == "F") == \
                        list(range(m))
                    assert sorted(x for k, x in order if k == "B") == \
                        list(range(m))
                    # B(m) never precedes F(m) on its own stage
                    seen_f = set()
                    for k, x in order:
                        if k == "F":
                            seen_f.add(x)
                        else:
                            assert x in seen_f


def test_1f1b_order_is_the_megatron_shape():
    # last stage: strict alternation from the start
    assert schedule_order("1f1b", 1, 2, 4) == \
        [("F", 0), ("B", 0), ("F", 1), ("B", 1),
         ("F", 2), ("B", 2), ("F", 3), ("B", 3)]
    # first stage of a 2-pipe: one warmup forward
    assert schedule_order("1f1b", 0, 2, 4)[:3] == \
        [("F", 0), ("F", 1), ("B", 0)]
    with pytest.raises(ValueError, match="unknown schedule"):
        schedule_order("interleaved", 0, 2, 4)


# ---------------------------------------------------------------------------
# acceptance invariants


# configs for the bit-identity / determinism invariants (host model and
# port contention included)
SWEPT_FIELDS = [
    dict(interface="ideal"),
    dict(interface="hbm"),
    dict(interface="hbm", host_dispatch_s=1e-6),
    dict(interface="acp", host_dispatch_s=1e-6, host_bw=20e9),
]

# configs for the schedule-dominance sweep: no shared-port contention and
# no serial host dispatch (tests/test_training.py's DOMINANCE_CONFIGS)
DOMINANCE_FIELDS = [dict(interface=i) for i in ("ideal", "hbm", "dma",
                                                "acp")]


@pytest.mark.parametrize("fields", DOMINANCE_FIELDS,
                         ids=[f["interface"] for f in DOMINANCE_FIELDS])
def test_1f1b_never_slower_than_gpipe(fields):
    """On every swept (homogeneous-stage, uncontended) config, 1F1B step
    time <= GPipe step time, to 1 ulp; every cell equal to the
    reference's."""
    jc, tc = cfg_pair(**fields)
    for p in (1, 2, 4, 8):
        for m in (1, 2, 8):
            g = both_training(jc, tc, n_stages=p, n_microbatches=m,
                              schedule="gpipe", seq_len=64, global_batch=8)
            o = both_training(jc, tc, n_stages=p, n_microbatches=m,
                              schedule="1f1b", seq_len=64, global_batch=8)
            assert o.step_time_s <= g.step_time_s * (1 + 1e-12), \
                (p, m, fields["interface"])


def test_bubble_matches_analytic_bound_on_homogeneous_stages():
    """With an ideal interface (free transfers) and equal stages, the
    measured bubble fraction IS (p-1)/(m+p-1)."""
    jc, tc = cfg_pair(interface="ideal")
    for sched in SCHEDULES:
        for p in (2, 4, 8):
            for m in (1, 2, 4, 8):
                r = both_training(jc, tc, n_stages=p, n_microbatches=m,
                                  schedule=sched, seq_len=64,
                                  global_batch=8)
                assert r.bubble_fraction == \
                    pytest.approx(bubble_bound(p, m), rel=1e-9), \
                    (sched, p, m)
                assert r.bubble_bound == bubble_bound(p, m) == \
                    jtraining.bubble_bound(p, m)


def test_uneven_stages_exceed_the_homogeneous_bound():
    """18 layers over 4 stages (5,5,4,4) is not homogeneous: the slowest
    stage paces the pipe, so the measured bubble exceeds the bound."""
    jc, tc = cfg_pair(interface="ideal")
    r = both_training(jc, tc, cfg=dataclasses.replace(TOY, n_layers=18),
                      jcfg=dataclasses.replace(JTOY, n_layers=18),
                      n_stages=4, n_microbatches=8, schedule="gpipe",
                      seq_len=64, global_batch=8)
    assert r.bubble_fraction > r.bubble_bound + 1e-3


def test_single_stage_single_microbatch_is_the_flat_chain_bitwise():
    """A 1-stage 1-microbatch simulated step is the flat
    ``from_training_step`` chain through ``engine.run``, bit for bit
    (timings, breakdown, roofline, energy; events modulo names)."""
    for fields in SWEPT_FIELDS:
        jc, config = cfg_pair(**fields)
        for dp in (1, 4):
            flat = from_training_step(TOY, seq_len=128, batch=8,
                                      dp_degree=dp)
            a = engine.run(flat, config)
            r = both_training(jc, config, n_stages=1, n_microbatches=1,
                              seq_len=128, global_batch=8, dp_degree=dp)
            assert engine.prepare(r.program).is_chain
            assert r.step_time_s == a.makespan
            assert r.engine.breakdown == a.breakdown
            assert r.engine.roofline == a.roofline
            assert r.engine.energy == a.energy
            assert [(e.start, e.duration, e.kind, e.worker)
                    for e in r.engine.timeline.events] == \
                [(e.start, e.duration, e.kind, e.worker)
                 for e in a.timeline.events]


def test_training_determinism_bit_identical():
    """Two identical runs produce bit-identical results."""
    jc, cfg = cfg_pair(interface="hbm", hbm_ports=2, host_dispatch_s=1e-6)
    for sched in SCHEDULES:
        a = both_training(jc, cfg, n_stages=4, n_microbatches=8,
                          schedule=sched, seq_len=64, global_batch=8)
        b = simulate_training(TOY, n_stages=4, n_microbatches=8,
                              schedule=sched, seq_len=64, global_batch=8,
                              config=cfg)
        assert a.step_time_s == b.step_time_s
        assert a.engine.timeline.events == b.engine.timeline.events
        assert a.engine.energy == b.engine.energy
        assert a.per_stage_utilization == b.per_stage_utilization
        assert a.bubble_fraction == b.bubble_fraction


# ---------------------------------------------------------------------------
# stage pinning, transfers, topologies


def test_stages_pin_to_distinct_devices():
    jc, tc = cfg_pair()
    r = both_training(jc, tc, n_stages=4, n_microbatches=2, seq_len=64,
                      global_batch=8)
    for e in r.engine.timeline.events:
        if e.kind == "compute" and e.name[0] in "FBU":
            s = int(e.name.split("/s")[1].split("/")[0])
            assert e.worker == f"stage{s}"
    assert set(r.per_stage_utilization) == {f"stage{s}" for s in range(4)}
    assert all(0.0 < u <= 1.0 for u in r.per_stage_utilization.values())


def test_interstage_transfers_are_real_and_contend():
    """Boundary tensors appear as transfer events on the receiving stage,
    and a 1-port shared link makes the step slower than an uncontended
    one."""
    base = dict(interface="hbm", overlap_transfers=False)
    kw = dict(n_stages=4, n_microbatches=4, seq_len=64, global_batch=8)
    free = both_training(*cfg_pair(**base), **kw)
    names = {e.name for e in free.engine.timeline.events}
    assert "xF/s1/m0:xfer" in names
    assert "xB/s0/m0:xfer" in names
    tight = both_training(*cfg_pair(hbm_ports=0.5, **base), **kw)
    assert tight.step_time_s > free.step_time_s


def _hetero_soc(hw_mod):
    return hw_mod.SoCTopology(
        devices=(hw_mod.Device("fast0"),
                 hw_mod.Device("slow", peak_flops=1e11),
                 hw_mod.Device("fast1"), hw_mod.Device("fast2")),
        links=(hw_mod.Link("hbm"),), name="hetero")


def test_custom_topology_maps_stages_and_heterogeneity_shows():
    """A provided topology's accel devices become the stages in order;
    a half-speed stage inflates the measured bubble past the bound."""
    fields = dict(interface="ideal", peak_flops=2e11)
    jc = jengine.EngineConfig(topology=_hetero_soc(jhw), **fields)
    tc = tcfg(topology=_hetero_soc(hw), **fields)
    r = both_training(jc, tc, n_stages=4, n_microbatches=8, seq_len=64,
                      global_batch=8)
    assert set(r.per_stage_utilization) == {"fast0", "slow", "fast1",
                                            "fast2"}
    assert r.bubble_fraction > r.bubble_bound + 1e-3
    # the slow stage is the busiest
    assert max(r.per_stage_utilization,
               key=r.per_stage_utilization.get) == "slow"


def test_simulate_training_errors():
    with pytest.raises(ValueError, match="not divisible"):
        simulate_training(TOY, n_stages=2, n_microbatches=3,
                          global_batch=8)
    with pytest.raises(ValueError, match="unknown schedule"):
        simulate_training(TOY, schedule="zb-h1")
    with pytest.raises(ValueError, match="n_microbatches"):
        simulate_training(TOY, n_microbatches=0)
    soc = SoCTopology(devices=(Device("a0"), Device("a1")))
    with pytest.raises(ValueError, match="stage-capable"):
        simulate_training(TOY, n_stages=4, n_microbatches=4,
                          global_batch=8,
                          config=engine.EngineConfig(topology=soc))


def test_all_cpu_topology_runs_stages_on_its_devices():
    """A topology without accelerator-class devices: every device is
    stage-capable (the engine's placement fallback), equal to the
    reference's."""
    jsoc = jhw.SoCTopology(devices=(jhw.Device("c0", kind="cpu"),
                                    jhw.Device("c1", kind="cpu")),
                           links=(jhw.Link("hbm"),), name="cpus")
    tsoc = SoCTopology(devices=(Device("c0", kind="cpu"),
                                Device("c1", kind="cpu")),
                       links=(Link("hbm"),), name="cpus")
    r = both_training(jengine.EngineConfig(topology=jsoc),
                      tcfg(topology=tsoc), n_stages=2, n_microbatches=4,
                      seq_len=64, global_batch=8)
    assert set(r.per_stage_utilization) == {"c0", "c1"}


# ---------------------------------------------------------------------------
# the sweep grid and the launcher dry-run


def test_training_sweep_grid_and_records():
    kw = dict(n_stages_grid=(1, 2), seq_len=64, n_microbatches_grid=(1, 4))
    results = training_sweep(TOY, base_config=tcfg(), **kw)
    jresults = jsweep.training_sweep(JTOY, **kw)
    assert len(results) == 8          # 2 stages x 2 microbatches x 2 scheds
    for j, t in zip(jresults, results):
        assert_same_training(j, t)
    rows = as_training_records(results)
    assert rows == jsweep.as_training_records(jresults)
    assert [r["n_stages"] for r in rows] == [1, 1, 1, 1, 2, 2, 2, 2]
    assert {r["schedule"] for r in rows} == {"gpipe", "1f1b"}
    # every cell simulated the same token count (LCM global batch)
    assert len({r["global_batch"] for r in rows}) == 1
    for row in rows:
        assert set(row) >= {"model", "schedule", "n_stages",
                            "n_microbatches", "step_time_s", "tokens_per_s",
                            "bubble_fraction", "bubble_bound",
                            "stage_util_mean", "total_j"}
        assert row["step_time_s"] > 0.0
        assert 0.0 <= row["bubble_fraction"] < 1.0


def test_training_sweep_on_the_bench_training_config():
    """``benchmarks/bench_training.py``'s contended config (hbm, 2 ports,
    10 us dispatch) on a cut of its grid, records ``==``."""
    fields = dict(interface="hbm", hbm_ports=2, host_dispatch_s=10e-6)
    kw = dict(n_stages_grid=(1, 4), n_microbatches_grid=(2, 8),
              seq_len=128, global_batch=8)
    jrows = jsweep.as_training_records(jsweep.training_sweep(
        JTOY, base_config=jengine.EngineConfig(**fields), **kw))
    rows = as_training_records(training_sweep(
        TOY, base_config=tcfg(**fields), **kw))
    assert rows == jrows and len(rows) == 8


def test_training_sweep_rejects_indivisible_global_batch():
    with pytest.raises(ValueError, match="not divisible"):
        training_sweep(TOY, n_stages_grid=(1,), n_microbatches_grid=(3,),
                       global_batch=8)


def test_launcher_dry_run_uses_the_simulator():
    """The reference's case on the port: one H100 at its bf16 peak."""
    lines = []
    out = tlaunch.dry_run("gemma_2b", "train_4k", n_stages=2,
                          n_microbatches=4, smoke=True, emit=lines.append)
    assert [r.schedule for r in out] == ["gpipe", "1f1b"]
    assert out[1].step_time_s <= out[0].step_time_s * (1 + 1e-12)
    assert len(lines) == 2 and all("bubble=" in ln for ln in lines)
    for r in out:
        assert r.config.peak_flops == hw.PEAK_FLOPS_BF16
        assert dataclasses.astuple(r.config) == dataclasses.astuple(
            dataclasses.replace(default_config(), topology=r.config.topology))


def test_launcher_dry_run_lines_equal_the_reference_at_v5e(monkeypatch):
    """At the v5e's constants the port's dry run prints the reference's
    lines, string for string, and prices the same results."""
    from repro.launch import train as jlaunch
    monkeypatch.setattr(tlaunch, "default_config", tcfg)
    kw = dict(n_stages=2, n_microbatches=4, smoke=True)
    jlines, tlines = [], []
    jout = jlaunch.dry_run("gemma_2b", "train_4k", emit=jlines.append, **kw)
    tout = tlaunch.dry_run("gemma_2b", "train_4k", emit=tlines.append, **kw)
    assert tlines == jlines and len(tlines) == 2
    for j, t in zip(jout, tout):
        assert_same_training(j, t)


def test_dry_run_cli_prices_without_touching_a_device(monkeypatch, capsys):
    """``--smoke --dry-run --stages 2 --microbatches 4``: a GPipe and a
    1F1B line, 1F1B no slower, and no training step, data or device."""
    def refuse(*a, **k):
        raise AssertionError("the dry run trained or touched a device")
    monkeypatch.setattr(tlaunch, "train", refuse)
    monkeypatch.setattr(tlaunch, "resolve_device", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    tlaunch.main(["--smoke", "--dry-run", "--stages", "2",
                  "--microbatches", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all("bubble=" in ln for ln in lines)
    assert lines[0].startswith("[dry-run] tinyllama_1_1b/train_4k gpipe "
                               "p=2 m=4: step=")
    assert lines[1].startswith("[dry-run] tinyllama_1_1b/train_4k 1f1b "
                               "p=2 m=4: step=")
    steps = [float(ln.split("step=")[1].split("ms")[0]) for ln in lines]
    assert 0.0 < steps[1] <= steps[0]
    tlaunch.main(["--smoke", "--dry-run", "--schedule", "1f1b"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and " 1f1b p=1 m=1: " in lines[0]


def test_dry_run_cli_in_a_fresh_process_touches_no_card():
    """The module as a user runs it: two ``bubble=`` lines, and CUDA never
    initialized."""
    code = ("import sys, torch\n"
            "from repro_torch.launch import train\n"
            "sys.argv = ['train', '--smoke', '--dry-run', '--stages', '2', "
            "'--microbatches', '4']\n"
            "train.main()\n"
            "assert not torch.cuda.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("bubble=") == 2


def test_training_simulator_imports_no_torch():
    """The training simulator and the sim package load numpy and the
    standard library only: no torch, no jax, no reference."""
    code = ("import sys\n"
            "import repro_torch.sim.training, repro_torch.sim\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
