"""The port's checkpointing (``repro_torch.ckpt``) on torch state, held
against the JAX package's, on the CPU.

``tests/test_checkpoint.py:23-62`` and ``tests/test_optim.py:65`` run on
trees of tensors; bf16 leaves round-trip bit for bit; and the layout is the
reference's: the port's checkpoint of a float32 tree has the reference's
file names and keys, and the reference's ``load_checkpoint`` reads it.
The elastic restore onto a mesh (``tests/test_checkpoint.py:63``) waits
for the port's distribution layer.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import load_checkpoint as j_load
from repro.ckpt import save_checkpoint as j_save
from repro_torch import configs as tconfigs
from repro_torch.ckpt import (CheckpointManager, load_checkpoint,
                              save_checkpoint)
from repro_torch.core import tree
from repro_torch.train import init_train_state


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"layers": {"w": torch.from_numpy(
                           r.standard_normal((4, 8)).astype(np.float32)),
                       "b": torch.from_numpy(
                           r.standard_normal(8).astype(np.float32))},
            "step_scale": torch.tensor(2.0)}


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t, extra={"lr": 0.1})
    out = load_checkpoint(str(tmp_path), template=t)
    assert out["step"] == 7
    assert out["extra"]["lr"] == 0.1
    np.testing.assert_array_equal(out["tree"]["layers"]["w"].numpy(),
                                  t["layers"]["w"].numpy())


def test_latest_selected(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(1))
    save_checkpoint(str(tmp_path), 5, _tree(5))
    out = load_checkpoint(str(tmp_path), template=_tree())
    assert out["step"] == 5


def test_async_manager_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(s))
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    assert mgr.latest_step() == 4


def test_crash_mid_save_leaves_previous_intact(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(1))
    # simulate a crashed save: stale tmp dir with garbage
    tmp = tmp_path / ".tmp_step_0000000002"
    tmp.mkdir()
    (tmp / "meta.json").write_text("{corrupt")
    out = load_checkpoint(str(tmp_path), template=_tree())
    assert out["step"] == 1  # tmp dirs are invisible to restore
    # and a retried save of step 2 succeeds over the stale tmp
    save_checkpoint(str(tmp_path), 2, _tree(2))
    assert load_checkpoint(str(tmp_path), template=_tree())["step"] == 2


def test_checkpoint_manager_error_propagates(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "nope\x00bad"), keep=1)
    mgr.save_async(1, {"w": torch.ones(3)})
    with pytest.raises(BaseException):
        mgr.wait()
    mgr.wait()   # the error is raised once


def test_async_save_copies_before_training_moves_on(tmp_path):
    """save_async copies the tree to the host at the call: an in-place
    update right after it does not reach the checkpoint."""
    t = _tree(3)
    expect = t["layers"]["w"].clone()
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save_async(1, t)
    t["layers"]["w"].add_(1.0)
    mgr.wait()
    out = mgr.restore(template=_tree())
    assert torch.equal(out["tree"]["layers"]["w"], expect)


def test_train_state_round_trips_bit_for_bit(tmp_path):
    """A train state of bf16 and float32 params, float32 moments and an
    int32 count, restored into a fresh state's template: every leaf equal
    bit for bit, in its dtype."""
    cfg = tconfigs.get_smoke_config("gemma3_1b")
    params, opt = init_train_state(cfg, 0, "cpu")
    for m in tree.leaves(opt["m"]):
        m.normal_()
    opt["count"] += 5
    state = {"params": params, "opt": opt}
    save_checkpoint(str(tmp_path), 3, state)
    fresh = dict(zip(("params", "opt"), init_train_state(cfg, 1, "cpu")))
    out = load_checkpoint(str(tmp_path), template=fresh)
    assert out["step"] == 3
    dtypes = set()
    for (key, a), b in zip(tree.flatten(state).items(),
                           tree.leaves(out["tree"])):
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert torch.equal(a, b), key
        dtypes.add(a.dtype)
    assert {torch.bfloat16, torch.float32, torch.int32} <= dtypes
    meta = json.loads((tmp_path / "step_0000000003" / "meta.json").read_text())
    assert meta["dtypes"]["params/embed"] == "bfloat16"
    assert "params/layers/0/attn/q" in meta["keys"]


def test_layout_is_the_references(tmp_path):
    """The same float32 tree saved by each package: the same files, the
    same keys; each package reads the other's checkpoint."""
    t = _tree(4)
    jt = {"layers": {k: jnp.asarray(v.numpy())
                     for k, v in t["layers"].items()},
          "step_scale": jnp.asarray(2.0)}
    save_checkpoint(str(tmp_path / "port"), 2, t, extra={"a": 1})
    j_save(str(tmp_path / "ref"), 2, jt, extra={"a": 1})
    names = [sorted(p.name for p in (tmp_path / d / "step_0000000002")
                    .iterdir()) for d in ("port", "ref")]
    assert names[0] == names[1] == ["arrays.npz", "meta.json"]
    metas = [json.loads((tmp_path / d / "step_0000000002" / "meta.json")
                        .read_text()) for d in ("port", "ref")]
    assert metas[0]["keys"] == metas[1]["keys"]
    assert metas[0]["extra"] == metas[1]["extra"]
    read_by_ref = j_load(str(tmp_path / "port"), template=jt)
    np.testing.assert_array_equal(np.asarray(read_by_ref["tree"]["layers"]
                                             ["w"]), t["layers"]["w"].numpy())
    read_by_port = load_checkpoint(str(tmp_path / "ref"), template=t)
    assert torch.equal(read_by_port["tree"]["layers"]["b"], t["layers"]["b"])
