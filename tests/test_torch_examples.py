"""The port's four examples (``examples_torch/``) held against the JAX
package's (``examples/``) on the CPU.

- quickstart: the residual unit's outputs against the reference's
  ``Graph.execute`` at ``tests/test_torch_graph.py``'s output tolerance
  (rtol 1e-4, atol 1e-4 max|reference|); its files ``==`` and read by the
  other package; the tiling choice and the 4-worker schedule ``==`` with the
  v5e target passed to the port (``tests/test_torch_sim.py``'s pattern).
- train_lm: the ``cpu-small`` preset from the reference's params, three
  steps through ``run`` and through the reference's jitted step on the same
  batches, cut to 2 x 32 tokens, at steps 20-22 past the warmup: each
  step's lr the reference's, loss and grad norm within 2e-2, params within
  2.5 times the lrs used (``tests/test_torch_train.py::
  test_train_step_matches_reference``'s bound of one step, summed over the
  steps), and each param's move within 0.25 of the reference's; the loss
  falling over 60 steps of the port's own; ``--resume`` through ``main``; a
  resume through ``run`` bit-equal to an uninterrupted run; a save that the
  next in-place step cannot tear.
- camera_pipeline: its measured half (``launch.camera.run_frame``), the ISP
  at ``tests/test_torch_camera.py``'s atol 1e-5 and CNN10's logits at 5e-4;
  the frame ``launch.camera.frame_timeline`` composes, its events ``==``
  the reference's with the v5e constants passed to the port.
- serve_batch: ``--simulate`` prints what the launcher prints.

The examples are loaded by path: ``examples_torch/`` is no package.
"""
import contextlib
import dataclasses
import importlib.util
import io
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_configs import reference_fields
from repro import configs as jconfigs
from repro.apps import camera as jcamera
from repro.apps.paper_graphs import build_paper_graph as ref_build
from repro.configs.paper_nets import PAPER_NETS as REF_NETS
from repro.core import graph as RG
from repro.core import scheduler as jsched
from repro.core import tiling as jtiling
from repro.core.tensor import TensorSpec as JTensorSpec
from repro.core.timeline import Timeline as JTimeline
from repro.sim import engine as jengine
from repro.sim import hw as jhw
from repro.sim.sweep import lower_graph as j_lower_graph
from repro.sim.sweep import sweep as j_sweep
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.apps.paper_graphs import build_paper_graph
from repro_torch.ckpt import CheckpointManager, load_checkpoint
from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.configs.paper_nets import PAPER_NETS
from repro_torch.core import graph as TG
from repro_torch.core import scheduler as tsched
from repro_torch.core import tiling as ttiling
from repro_torch.core import tree
from repro_torch.core.tensor import TensorSpec
from repro_torch.data import synthetic_batch
from repro_torch.launch import camera
from repro_torch.optim import adamw_init
from repro_torch.sim import engine as tengine
from repro_torch.sim import ir as tir
from repro_torch.train import TrainConfig, init_train_state

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import load_example  # noqa: E402  (the examples' loader)
OUT_TOL = 1e-4          # tests/test_torch_graph.py
ISP_TOL = 1e-5          # tests/test_torch_camera.py
LOGIT_TOL = 5e-4        # chip_smoke.py's GRAPH_TOL
BF16_TOL = 2e-2         # tests/test_torch_train.py
LR = 1e-3               # train_lm's TrainConfig: the schedule's peak
# train_lm's cuts here: batch x seq of the parity, resume and longer runs
CUT = dict(batch=2, seq=32)
PARITY_STEPS = (20, 23)     # steps [20, 23): past the 20-step warmup
FALL_STEPS = 60
# every EngineConfig field whose default the port takes from its hw module
# (tests/test_torch_sim.py), at the reference's v5e values
HW_FIELDS = ("peak_flops", "hbm_bw", "vmem_bw", "ici_bw", "ici_lat_s",
             "node_bw", "node_lat_s", "inter_bw", "inter_lat_s")
V5E = {f: getattr(jhw, f.upper()) for f in HW_FIELDS}
V5E_TILING = ttiling.TilingTarget(
    reduce_quantum=jtiling.MXU_DIM, hbm_bw=jtiling.HBM_BW,
    copy_latency_s=jtiling.HBM_LATENCY_US * 1e-6)
SOC = dict(n_workers=8, interface="acp", hbm_ports=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_close(out, expect, tol):
    expect = np.asarray(expect)
    np.testing.assert_allclose(np.asarray(out), expect, rtol=tol,
                               atol=tol * np.abs(expect).max())


def _events(tl):
    return [(e.worker, e.name, e.start, e.duration, e.kind, e.phase)
            for e in tl.events]


# ---------------------------------------------------------------------------
# quickstart


@pytest.fixture(scope="module")
def quickstart():
    spec = importlib.util.spec_from_file_location(
        "examples_quickstart", ROOT / "examples" / "quickstart.py")
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    return load_example("quickstart"), reference


def test_quickstart_main_matches_reference(quickstart, tmp_path, capsys):
    """``main`` on the CPU: the unit's output against the reference's
    ``Graph.execute`` on the same input, and the reference's lines."""
    tq, jq = quickstart
    out = tq.main(["--device", "cpu", "--out", str(tmp_path / "unit")])
    lines = capsys.readouterr().out.splitlines()
    jg = jq.create_residual_unit()
    (expect,) = jg.execute({"input": tq.feeds()["input"]}).values()
    (got,) = out["outputs"].values()
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    _assert_close(got.numpy(), expect, OUT_TOL)
    assert lines[0] == f"graph: 6 nodes -> {tmp_path / 'unit'}.json/.npz"
    assert lines[1] == "outputs: {'add': (1, 32, 32, 8)}"
    assert lines[2] == f"tiling optimizer chose: {out['choice']}"
    tl = out["timeline"]
    assert lines[3] == (f"4-worker makespan: {tl.makespan*1e6:.1f} us, "
                        f"utilization {tl.utilization():.2f}")
    assert "\n".join(lines[4:]) == tl.ascii(width=60)
    assert (tmp_path / "unit.json").exists() and \
        (tmp_path / "unit.npz").exists()


def test_quickstart_files_equal_and_cross_read(quickstart, tmp_path):
    """Both packages write the same topology and arrays; each reads the
    other's files and runs them to the outputs of its own unit."""
    tq, jq = quickstart
    tg, jg = tq.create_residual_unit(), jq.create_residual_unit()
    tg.write_graph(str(tmp_path / "t"))
    jg.write_graph(str(tmp_path / "j"))
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert t.files == j.files == ["f0", "f1"]
        for k in t.files:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])
    feeds = tq.feeds()
    (own_t,) = tg.execute(feeds, device="cpu").values()
    (own_j,) = jg.execute(feeds).values()
    (t_of_j,) = TG.Graph.read_graph(str(tmp_path / "j")).execute(
        feeds, device="cpu").values()
    (j_of_t,) = RG.Graph.read_graph(str(tmp_path / "t")).execute(
        feeds).values()
    assert torch.equal(t_of_j, own_t)
    np.testing.assert_array_equal(np.asarray(j_of_t), np.asarray(own_j))
    _assert_close(t_of_j.numpy(), own_j, OUT_TOL)


def test_quickstart_tiling_and_schedule_match_reference(quickstart):
    """At the v5e target the port's tiling choice and tile tasks are the
    reference's, and the 4-worker schedules are ``==``: makespan,
    utilization and every event."""
    tq, jq = quickstart
    choice = ttiling.choose_tiling(TensorSpec((1, 32, 32, 64), "NHWC",
                                              "float32"),
                                   max_tile_elems=16384, reduce_dim="C",
                                   target=V5E_TILING)
    expect = jtiling.choose_tiling(JTensorSpec((1, 32, 32, 64), "NHWC",
                                               "float32"),
                                   max_tile_elems=16384, reduce_dim="C")
    assert dataclasses.astuple(choice) == dataclasses.astuple(expect)
    assert str(choice) == str(expect)
    ttasks = tq.create_residual_unit().tile_tasks(target=V5E_TILING)
    jtasks = jq.create_residual_unit().tile_tasks()
    assert [(t.name, t.affinity, t.deps) for t in ttasks] == \
        [(t.name, t.affinity, t.deps) for t in jtasks]
    ttl = tsched.simulate(ttasks, n_workers=4)
    jtl = jsched.simulate([jsched.TileTask(t.name, t.duration, t.affinity,
                                           t.transfer, t.deps)
                           for t in ttasks], n_workers=4)
    assert ttl.makespan == jtl.makespan > 0
    assert ttl.utilization() == jtl.utilization()
    assert _events(ttl) == _events(jtl)
    assert ttl.ascii(width=60) == jtl.ascii(width=60)


# ---------------------------------------------------------------------------
# train_lm


@pytest.fixture(scope="module")
def train_lm():
    return load_example("train_lm")


def _batches(cfg, steps, start=0):
    """The batch of step i: ``synthetic_batch`` at seed i."""
    return (synthetic_batch(cfg, CUT["batch"], CUT["seq"],
                            np.random.default_rng(i))
            for i in range(start, steps))


def _np(t):
    return t.detach().float().numpy()


def test_train_lm_cpu_small_matches_reference(train_lm):
    """Three steps of the ``cpu-small`` preset from the reference's params
    (``init_train_state(cfg, PRNGKey(0))``) through ``run`` and through the
    reference's jitted step on the same batches, at steps ``PARITY_STEPS``
    (batches at seeds 20-22): past the 20-step warmup, where the lr is near
    its peak, each step moves an element by about lr and the loss falls by
    about 1, so an update skipped or taken at another lr shows.

    Each step's lr equals the reference's; loss and grad norm within 2e-2.
    Every param within 2.5 times the lr each step used, summed over the
    steps, of the reference's: ``test_train_step_matches_reference``'s
    bound of one step, where AdamW moves each element by about lr sign(g)
    and an element whose bf16 gradient parts in sign near 0 parts by up to
    2 lr; such elements, and only a few (under 1%), part by more than 2e-2
    of the largest value.  Each param's move over the three steps within
    0.25 of the reference's move, in L2 (a skipped update is 1)."""
    start, steps = PARITY_STEPS
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("tinyllama_1_1b"),
                               n_layers=4, d_model=256, n_heads=8,
                               n_kv_heads=4, d_ff=704, vocab=2048)
    tcfg = train_lm.preset_config("tinyllama_1_1b", "cpu-small")
    assert reference_fields(tcfg, jcfg) == dataclasses.asdict(jcfg)
    jparams, jopt, _, _ = j_init_train_state(jcfg, jax.random.PRNGKey(0))

    def from_jax(p):
        return convert.params_from_jax(jax.tree_util.tree_map(
            lambda a: np.asarray(a.astype(jnp.float32)), p))
    tparams, before = from_jax(jparams), from_jax(jparams)
    kw = dict(lr=LR, warmup=20, total_steps=100)
    out = train_lm.run(tcfg, TrainConfig(**kw), tparams, adamw_init(tparams),
                       _batches(tcfg, steps, start), start, steps,
                       log=lambda s: None)
    jstep = jax.jit(j_make_train_step(jcfg, JTrainConfig(**kw)))
    jlosses, jgnorms, jlrs = [], [], []
    for i, b in zip(range(start, steps), _batches(tcfg, steps, start)):
        jparams, jopt, m = jstep(jparams, jopt,
                                 {k: jnp.asarray(v) for k, v in b.items()},
                                 jnp.asarray(i, jnp.int32))
        jlosses.append(float(m["loss"]))
        jgnorms.append(float(m["grad_norm"]))
        jlrs.append(float(m["lr"]))
    assert min(jlrs) > 0.99 * LR
    np.testing.assert_allclose(out["lrs"], jlrs, rtol=1e-6)
    np.testing.assert_allclose(out["losses"], jlosses, rtol=BF16_TOL)
    np.testing.assert_allclose(out["gnorms"], jgnorms, rtol=BF16_TOL)
    bound = 2.5 * sum(jlrs)
    for (key, t), j, t0 in zip(tree.flatten(out["params"]).items(),
                               tree.leaves(from_jax(jparams)),
                               tree.leaves(before)):
        assert t.dtype == j.dtype, key
        t, j, t0 = _np(t), _np(j), _np(t0)
        np.testing.assert_allclose(t, j, rtol=0, atol=bound, err_msg=key)
        parted = np.abs(t - j) > BF16_TOL * np.abs(j).max()
        assert parted.mean() < 0.01, (key, parted.mean())
        moved = np.linalg.norm(j - t0)
        assert moved > 0, key
        assert np.linalg.norm((t - t0) - (j - t0)) <= 0.25 * moved, key


def _logged(lines):
    """(step, loss) of each ``step i loss=`` line."""
    return [(int(m[1]), float(m[2])) for m in
            (re.match(r"step +(\d+) loss=([\d.]+) gnorm=[\d.]+ tok/s=\d+$",
                      s) for s in lines) if m]


def _main(train_lm, capsys, *args):
    out = train_lm.main(["--device", "cpu", "--batch", str(CUT["batch"]),
                         "--seq", str(CUT["seq"]), *args])
    return out, capsys.readouterr().out.splitlines()


def test_train_lm_loss_falls(train_lm, tmp_path, capsys):
    """``FALL_STEPS`` steps of the port's own run through ``main``: the
    mean of the last five logged losses is below step 0's."""
    out, lines = _main(train_lm, capsys, "--steps", str(FALL_STEPS),
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "100")
    n_params = sum(p.numel() for p in tree.leaves(out["params"]))
    assert lines[0] == (f"arch=tinyllama_smoke params={n_params / 1e6:.1f}M "
                        f"batch={CUT['batch']} seq={CUT['seq']}")
    logged = _logged(lines)
    assert [s for s, _ in logged] == [0, 10, 20, 30, 40, 50, 59]
    assert [x for _, x in logged] == [round(out["losses"][s], 3)
                                      for s, _ in logged]
    assert np.mean([x for _, x in logged[-5:]]) < logged[0][1]
    assert lines[-1] == f"done; checkpoints in {tmp_path}"
    assert CheckpointManager(str(tmp_path)).latest_step() == FALL_STEPS - 1


def test_train_lm_resume_through_main(train_lm, tmp_path, capsys,
                                      monkeypatch):
    """``--steps 4 --ckpt-every 2``, then ``--resume --steps 6``: the run
    resumes from step 3's checkpoint, restored bit for bit, and runs steps
    4-5."""
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first, _ = _main(train_lm, capsys, "--steps", "4", *ckpt)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_0000000002", "step_0000000003"]
    restored = []
    inner = train_lm.restore

    def keep(mgr, params, opt, log=print):
        out = inner(mgr, params, opt, log)
        restored.append(tree.map_tree(lambda t: t.clone(), out[:2]))
        return out
    monkeypatch.setattr(train_lm, "restore", keep)
    second, lines = _main(train_lm, capsys, "--steps", "6", "--resume",
                          *ckpt)
    assert "resumed from step 3" in lines
    assert second["start"] == 4 and len(second["losses"]) == 2
    assert [s for s, _ in _logged(lines)] == [5]
    saved = {"params": first["params"], "opt": first["opt"]}
    (got,) = restored
    flat_saved = tree.flatten(saved)
    flat_got = tree.flatten({"params": got[0], "opt": got[1]})
    assert flat_got.keys() == flat_saved.keys()
    for k, t in flat_saved.items():
        assert flat_got[k].dtype == t.dtype and \
            torch.equal(flat_got[k], t), k


def test_train_lm_resume_through_run_is_bit_equal(train_lm, tmp_path):
    """Three steps, a checkpoint, a restore into fresh state and three more
    steps equal six uninterrupted steps bit for bit (batches keyed by
    step)."""
    cfg = train_lm.preset_config("tinyllama_1_1b", "cpu-small")
    tc = TrainConfig(lr=LR, warmup=20, total_steps=6)
    quiet = dict(log=lambda s: None)
    whole = train_lm.run(cfg, tc, *init_train_state(cfg, 0, "cpu"),
                         _batches(cfg, 6), 0, 6, **quiet)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    first = train_lm.run(cfg, tc, *init_train_state(cfg, 0, "cpu"),
                         _batches(cfg, 3), 0, 3, mgr, ckpt_every=100,
                         **quiet)
    params, opt, start = train_lm.restore(
        mgr, *init_train_state(cfg, 1, "cpu"), **quiet)
    assert start == 3
    rest = train_lm.run(cfg, tc, params, opt, _batches(cfg, 6, 3), 3, 6,
                        **quiet)
    assert first["losses"] + rest["losses"] == whole["losses"]
    a = tree.flatten({"params": rest["params"], "opt": rest["opt"]})
    b = tree.flatten({"params": whole["params"], "opt": whole["opt"]})
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_train_lm_save_survives_the_next_step(train_lm, tmp_path,
                                             monkeypatch):
    """``save_async`` copies to the host before it returns: a step that
    updates the params in place before the writer writes (held back until
    the step is done) leaves the saved arrays equal to the params before
    it."""
    cfg = train_lm.preset_config("tinyllama_1_1b", "cpu-small")
    params, opt = init_train_state(cfg, 0, "cpu")
    before = tree.map_tree(lambda t: t.clone(), params)
    stepped = threading.Event()
    write = ckpt_mod._write

    def late_write(*args, **kw):
        assert stepped.wait(60)
        return write(*args, **kw)
    monkeypatch.setattr(ckpt_mod, "_write", late_write)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save_async(5, {"params": params, "opt": opt})
    train_lm.run(cfg, TrainConfig(lr=LR, warmup=1, total_steps=10), params,
                 opt, _batches(cfg, 6, 5), 5, 6, log=lambda s: None)
    stepped.set()
    mgr.wait()
    saved = load_checkpoint(str(tmp_path), template={"params": before})
    for k, t in tree.flatten(before).items():
        assert torch.equal(tree.flatten(saved["tree"]["params"])[k], t), k
    moved = [not torch.equal(a, b) for a, b in zip(tree.leaves(params),
                                                   tree.leaves(before))]
    assert all(moved)


# ---------------------------------------------------------------------------
# camera_pipeline


@pytest.fixture(scope="module")
def camera_example():
    return load_example("camera_pipeline")


def test_camera_measure_matches_reference():
    """The measured half (``launch.camera.run_frame``) on a (180, 320)
    frame: the ISP against the reference's ``camera_pipeline``, CNN10's
    logits against the reference's ``Graph.execute`` on the reference's DNN
    input."""
    raw = np.random.default_rng(0).random((180, 320), dtype=np.float32)
    g = build_paper_graph(PAPER_NETS["cnn10"], batch=1)
    out = camera.run_frame(raw, g, "cpu")
    e_rgb, e_dnn = jcamera.camera_pipeline(raw, dnn_hw=(32, 32))
    np.testing.assert_allclose(out["rgb"].numpy(), np.asarray(e_rgb),
                               atol=ISP_TOL)
    np.testing.assert_allclose(out["dnn_in"].numpy(), np.asarray(e_dnn),
                               atol=ISP_TOL)
    (e_logits,) = ref_build(REF_NETS["cnn10"], batch=1).execute(
        {"input": np.asarray(e_dnn)[None]}).values()
    _assert_close(out["logits"].numpy(), e_logits, LOGIT_TOL)
    assert out["isp_ms"] > 0 and out["cnn_ms"] > 0


def _ref_frame(isp_s):
    """``examples/camera_pipeline.py``'s simulated half (its lines 53-60)
    on the reference's CNN10."""
    prog = j_lower_graph(ref_build(REF_NETS["cnn10"], batch=1), batch=1,
                         max_tile_elems=16384)
    (res,) = j_sweep(prog, [jengine.EngineConfig(**SOC)])
    tl = JTimeline()
    tl.add("cpu", "isp", 0.0, isp_s, "host")
    for e in res.timeline.events:
        tl.add(e.worker, e.name, isp_s + e.start, e.duration, e.kind)
    return tl


@pytest.mark.parametrize("isp_s", [0.0123, 0.05])
def test_camera_frame_timeline_matches_reference(isp_s):
    """With the same ISP time, the port's CNN10 lowered at the v5e target
    and the SoC at the v5e constants, the frame that
    ``launch.camera.frame_timeline`` composes is the reference's event for
    event."""
    prog = tir.from_graph(build_paper_graph(PAPER_NETS["cnn10"], batch=1),
                          batch=1, max_tile_elems=16384, target=V5E_TILING)
    tl = camera.frame_timeline(prog, isp_s,
                               tengine.EngineConfig(**V5E, **SOC))
    expect = _ref_frame(isp_s)
    assert _events(tl) == _events(expect)
    assert tl.makespan == expect.makespan
    assert tl.ascii(width=64) == expect.ascii(width=64)


def test_camera_main_on_cpu(camera_example, capsys):
    """``main --device cpu``: the 720p frame measured, CNN10 priced on the
    8-accelerator SoC at H100 constants after it, the verdict and the
    chart."""
    out = camera_example.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert out["rgb"].shape == (720, 1280, 3)
    assert lines[0] == (f"ISP (720p raw -> RGB + 32x32 DNN input): "
                        f"{out['isp_ms']:.1f} ms")
    assert lines[1] == (f"CNN10 inference: {out['cnn_ms']:.1f} ms, "
                        f"class={out['cls']}")
    tl = out["timeline"]
    total_ms = tl.makespan * 1e3
    assert lines[3].startswith(
        f"frame time (ISP on CPU + CNN10 on 8 accelerators): "
        f"{total_ms:.1f} ms — {'MEETS' if total_ms < 33 else 'MISSES'}")
    assert "\n".join(lines[4:]) == tl.ascii(width=64)
    isp = [e for e in tl.events if e.name == "isp"]
    assert [(e.worker, e.start, e.duration, e.kind) for e in isp] == \
        [("cpu", 0.0, out["isp_ms"] * 1e-3, "host")]
    assert min(e.start for e in tl.events if e.name != "isp") == \
        out["isp_ms"] * 1e-3


# ---------------------------------------------------------------------------
# serve_batch, and every example's default device


def test_serve_batch_simulate_prints_the_launchers_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = [subprocess.run([sys.executable, *cmd, "--simulate"], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=120)
            for cmd in (["examples_torch/serve_batch.py"],
                        ["-m", "repro_torch.launch.serve_batch"])]
    for r in runs:
        assert r.returncode == 0, r.stderr
    assert runs[0].stdout == runs[1].stdout
    assert runs[0].stdout.startswith("simulated 64 requests @ 50 req/s on "
                                     "gemma3_1b (smoke config)")


@pytest.mark.parametrize("name", ["quickstart", "train_lm",
                                  "camera_pipeline", "serve_batch"])
def test_examples_need_the_card_unless_told(name, monkeypatch, tmp_path):
    """``--device`` defaults to ``cuda``, which raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"quickstart": ["--out", str(tmp_path / "unit")],
            "train_lm": ["--ckpt-dir", str(tmp_path)]}.get(name, [])
    mod = load_example(name)
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(args)
    assert not list(tmp_path.iterdir())
