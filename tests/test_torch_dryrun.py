"""The port's dry run (``repro_torch.launch.dryrun``) and its hillclimb
step (``launch.perf_iter``), on the CPU, allocating nothing.

  * one cell of each kind of tinyllama_1_1b's and granite_moe_1b_a400m's
    SMOKE configs (granite: the MoE's expert count, which fake tensors
    could not trace while it was a ``bincount``) at small shapes on a
    fake (data 2, model 4) mesh: records with the reference's fields,
    collectives on the multi-rank train cell, ``skip`` records where
    ``cell_is_runnable`` says so, and a rerun that skips cached cells;
  * ``perf_iter``'s CLI on a decode cell, ``--out`` in ``tmp_path``;
  * in a subprocess, so that its fake group never outlives the test,
    tinyllama_1_1b's full-width ``train_4k`` cell on the fake 16 x 16
    mesh through the CLI;
  * the SMOKE train step's ``analyze_step`` against the reference's
    ``analyze_hlo`` of its jitted step on one CPU device (see
    ``test_train_step_dot_flops_against_the_reference``);
  * the two repairs that let fake tensors through: the MoE's expert
    counts, ``distribute``'s storage comparison.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.hlo import analyze_hlo as ref_analyze_hlo
from repro_torch.core.config import ShapeConfig
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
SMALL = (ShapeConfig("train_4k", seq_len=64, global_batch=8, kind="train"),
         ShapeConfig("prefill_32k", seq_len=64, global_batch=8,
                     kind="prefill"),
         ShapeConfig("decode_32k", seq_len=64, global_batch=8,
                     kind="decode"),
         ShapeConfig("long_500k", seq_len=128, global_batch=1,
                     kind="decode"))
RECORD = {"arch", "shape", "mesh", "kind", "perf", "timestamp", "status",
          "lower_s", "compile_s", "memory", "cost", "hlo"}
HLO_KEYS = {"flops", "dot_flops", "transcendentals", "bytes",
            "collective_bytes", "wire_bytes", "collectives", "n_while",
            "custom_calls", "entry"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host2x4():
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(2, 4, device_type="cpu")


@pytest.fixture(scope="module")
def smoke_sweep(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry")
    res = dryrun.sweep(["tinyllama_1_1b", "granite_moe_1b_a400m"], SMALL,
                       {"host2x4": (8, _host2x4)}, out, smoke=True)
    return out, res


def test_smoke_cells_have_the_reference_records(smoke_sweep):
    _, res = smoke_sweep
    assert len(res) == 8
    for key, rec in res.items():
        arch, shape, mesh = key.split("|")
        assert (rec["arch"], rec["shape"], rec["mesh"]) == (arch, shape, mesh)
        if shape == "long_500k":       # pure full attention: skipped
            assert rec["status"] == "skip"
            assert "long_500k" in rec["reason"]
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        assert set(rec) == RECORD
        assert rec["compile_s"] == 0.0 and rec["lower_s"] > 0
        assert set(rec["memory"]) == MEMORY
        assert HLO_KEYS <= set(rec["hlo"])
        assert rec["hlo"]["flops"] >= rec["hlo"]["dot_flops"] > 0
        assert rec["cost"]["flops"] == rec["hlo"]["flops"]
        assert rec["memory"]["argument_bytes"] > 0
        if rec["kind"] != "decode":
            assert rec["hlo"]["custom_calls"] == {
                "flash_attention": 2 * (2 if rec["kind"] == "train" else 1)}
        if rec["kind"] == "train":
            assert rec["hlo"]["collective_bytes"] > 0
            assert rec["hlo"]["collectives"]["all-reduce"]["count"] > 0
            assert rec["memory"]["alias_bytes"] > 0   # params in place


def test_sweep_is_resumable(smoke_sweep, capsys):
    out, res = smoke_sweep
    assert json.loads((out / "results.json").read_text()).keys() \
        == res.keys()
    again = dryrun.sweep(["tinyllama_1_1b"], SMALL[:2],
                         {"host2x4": (8, _host2x4)}, out, smoke=True)
    printed = capsys.readouterr().out
    assert printed.count("[cached]") == 2 and "[run]" not in printed
    assert again == res


def test_perf_iter_cli(tmp_path):
    from repro_torch.launch import perf_iter
    out = tmp_path / "iters.json"
    assert perf_iter.main(["--arch", "tinyllama_1_1b", "--shape",
                           "decode_32k", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())["tinyllama_1_1b|decode_32k||mb1"]
    assert rec["hlo"]["collective_bytes"] > 0
    rl = rec["roofline"]
    assert rl["bound"] in ("compute", "memory", "collective")
    assert rl["memory_s"] == pytest.approx(rec["hlo"]["bytes"] / 3.35e12)


def test_full_width_train_cell_on_the_production_mesh(tmp_path):
    """tinyllama_1_1b's ``train_4k`` at full width on the fake 16 x 16
    mesh through the CLI: rank 0's step has the all-reduces of its
    ``model`` regions and the data-parallel gradient mean, and at least
    MODEL_FLOPS / 256 of products."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama_1_1b", "--shape", "train_4k", "--mesh", "single",
         "--out", str(tmp_path)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "TOTAL ok=1 skip=0 error=0" in proc.stdout
    rec = json.loads((tmp_path / "results.json").read_text())[
        "tinyllama_1_1b|train_4k|pod16x16"]
    hlo = rec["hlo"]
    assert hlo["collective_bytes"] > 0 and hlo["wire_bytes"] > 0
    assert hlo["custom_calls"] == {"flash_attention": 44}   # 22 x (fwd, remat)
    from repro_torch.configs import get_config
    from repro_torch.core.config import SHAPE_BY_NAME
    from repro_torch.core.simulator import model_flops
    mf = model_flops(get_config("tinyllama_1_1b"), SHAPE_BY_NAME["train_4k"])
    assert hlo["dot_flops"] >= mf / 256


def _dot_flops_pair(arch, B, S):
    """(the port's ``analyze_step`` of its SMOKE train step, the reference's
    ``analyze_hlo`` of its jitted step), both on one CPU device."""
    from repro.configs import get_smoke_config as ref_smoke
    from repro.models import transformer as RT
    from repro.optim import adamw_init as ref_adamw
    from repro.train import TrainConfig as RefTC
    from repro.train import make_train_step as ref_step
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.hlo import analyze_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    cfg = ref_smoke(arch)
    params, _ = RT.init_params(cfg, jax.random.PRNGKey(0))
    batch = {k: jnp.zeros((B, S), jnp.int32) for k in ("tokens", "labels")}
    text = jax.jit(ref_step(cfg, RefTC())).lower(
        params, ref_adamw(params), batch, jnp.int32(1)).compile().as_text()
    tcfg = get_smoke_config(arch)
    tparams = T.init_params(tcfg, 0, "cpu")
    tbatch = {k: torch.zeros(B, S, dtype=torch.long)
              for k in ("tokens", "labels")}
    got = analyze_step(make_train_step(tcfg, TrainConfig()), tparams,
                       adamw_init(tparams), tbatch, 1)
    return tcfg, got, ref_analyze_hlo(text)


def test_train_step_dot_flops_against_the_reference():
    """The SMOKE train step's ``dot_flops``, the port's against the
    reference's on one CPU device.  Both remat the blocks (the forward is
    recomputed in the backward), and their linear layers' products are
    equal; the gap is attention and the scan, each term computed here.

    Attention, X = 4 B H S^2 D a layer (Q K^T and P V over every pair):
      the reference's jnp ``chunked_attention`` (512-key chunks, masked,
      none skipped): forward X, its recompute X, backward 2X: 4X;
      the port: the flash kernel priced by its accounting, causal, X/2,
      and X/2 again for the recompute; the plain backward
      (``kernels.ref.flash_attention_bwd_ref``) recomputes each 512-query
      chunk against the keys up to its last row and differentiates it.
      At S <= 512 that is one chunk over all keys, X + 2X, so the port's
      4X equals the reference's: ``==`` at S = 128.  At S = 1024 it is
      (X/4 + X/2) + (X/2 + X): 2.25X, so the port's 3.25X is 0.75X a layer
      below the reference's.
    The selective scan (falcon_mamba_7b): the reference's contraction of
      the state with C (and its recompute and backward) is a dot in XLA,
      6 B S d_inner N a layer; the port prices the scan kernel's FLOPs as
      non-dot, as its accounting does, and its plain backward's product
      with C is elementwise.
    """
    B = 1
    cfg, got, ref = _dot_flops_pair("tinyllama_1_1b", B, 128)
    assert got["dot_flops"] == ref["dot_flops"]
    cfg, got, ref = _dot_flops_pair("tinyllama_1_1b", B, 1024)
    X = 4 * B * cfg.n_heads * 1024 ** 2 * cfg.resolved_head_dim
    assert ref["dot_flops"] - got["dot_flops"] == 0.75 * X * cfg.n_layers
    assert abs(got["dot_flops"] - ref["dot_flops"]) / ref["dot_flops"] < 0.15
    cfg, got, ref = _dot_flops_pair("falcon_mamba_7b", B, 64)
    d_in = cfg.ssm.expand * cfg.d_model
    assert ref["dot_flops"] - got["dot_flops"] \
        == 6 * B * 64 * d_in * cfg.ssm.d_state * cfg.n_layers
    assert got["custom_calls"] == {"mamba_scan": 2 * cfg.n_layers}


def test_expert_counts_equal_bincount_and_trace_on_fake_tensors():
    """The MoE repair: ``moe._expert_counts`` is ``bincount``'s count,
    ``==``, and has a static shape, so that fake tensors trace it
    (``bincount``'s output shape depends on the data)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(0)
    for E, n in ((4, 16), (64, 4096), (32, 7)):
        idx = torch.randint(0, E, (n,), generator=g)
        assert torch.equal(moe._expert_counts(idx, E),
                           torch.bincount(idx, minlength=E).float())
    with FakeTensorMode():
        idx = torch.empty(4096, dtype=torch.long)
        assert moe._expert_counts(idx, 64).shape == (64,)
        with pytest.raises(Exception, match="bincount"):
            torch.bincount(idx, minlength=64)


def test_distribute_takes_fake_tensors_without_reading_storage():
    """The sharding repair: ``distribute`` of fake tensors (which own no
    storage) reads no data pointer, so it warns nothing; each rank keeps
    its shard."""
    import warnings
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_host_mesh
    with dryrun.fake_world(2):
        mesh = make_host_mesh(1, 2, device_type="cpu")
        rules = sharding.Rules({"d_ff": "model"}, mesh)
        always = torch.is_warn_always_enabled()
        torch.set_warn_always(True)       # the warning is a once-only one
        try:
            with FakeTensorMode(), warnings.catch_warnings():
                warnings.simplefilter("error")
                tree = {"w": torch.empty(64, 256), "b": torch.empty(8)}
                out = sharding.distribute(
                    tree, rules.tree_shardings({"w": (None, "d_ff"),
                                                "b": (None,)}, tree), mesh)
                assert out["w"].to_local().shape == (64, 128)
                assert out["b"].to_local().shape == (8,)
        finally:
            torch.set_warn_always(always)


def test_windowed_attention_prices_fewer_decode_bytes(tmp_path):
    """``--perf windowed_attention`` on the rules' shards: gemma3_1b's
    local layers (SMOKE window 8) read only their window's slice of the
    64- or 128-position cache, so each decode cell prices fewer bytes than
    without the flag, as the reference's static-window decode does.
    ``decode_32k`` splits the one KV head's ``head_dim`` over ``model``;
    ``long_500k`` (batch 1) splits ``kv_seq`` over ``data``, where the
    window's slice lies in one rank's positions."""
    shapes = SMALL[2:]
    meshes = {"host2x4": (8, _host2x4)}
    plain = dryrun.sweep(["gemma3_1b"], shapes, meshes, tmp_path / "plain",
                         smoke=True)
    flagged = dryrun.sweep(["gemma3_1b"], shapes, meshes, tmp_path / "flag",
                           smoke=True, perf="windowed_attention")
    for shape in shapes:
        a, = [r for r in plain.values() if r["shape"] == shape.name]
        b, = [r for r in flagged.values() if r["shape"] == shape.name]
        assert a["status"] == b["status"] == "ok", (a, b)
        assert b["hlo"]["bytes"] < a["hlo"]["bytes"], shape.name
        assert b["hlo"]["dot_flops"] < a["hlo"]["dot_flops"], shape.name
