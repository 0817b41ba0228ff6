"""Elastic scaling on the port, on the CPU: a checkpoint saved under one
mesh restores onto a different one (the node-loss / re-provisioning path).

Mirrors ``tests/test_elastic.py`` (saved on 4 ranks at (data 2, model 2),
``P("data", "model")``, restored on 8 ranks at (8, 1) with ``P("data",
None)``, here the placements ``(Shard(0), Replicate())``) and
``tests/test_checkpoint.py:63-75`` (a checkpoint saved unsharded restores
onto a mesh with explicit placements).  The ranks are gloo process groups
(``_torch_dist.spawn``).
"""
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

import _torch_dist
from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.core import tree
from repro_torch.core.config import SHAPE_BY_NAME
from repro_torch.dist.sharding import rules_for
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"layers": {"w": torch.from_numpy(r.standard_normal((4, 8))
                                             .astype(np.float32)),
                       "b": torch.from_numpy(r.standard_normal(8)
                                             .astype(np.float32))},
            "step_scale": torch.tensor(2.0)}


def test_checkpoint_roundtrips_across_meshes(tmp_path):
    expect = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    ckpt = str(tmp_path / "ckpt")
    saved = _torch_dist.spawn(_torch_dist.rank_save, 4, tmp_path, ckpt,
                              expect, (2, 2), (Shard(0), Shard(1)))
    assert saved == [(4, 4)] * 4          # each rank held a quarter
    # DIFFERENT topology: 8-way data-parallel only (elastic re-mesh)
    restored = _torch_dist.spawn(_torch_dist.rank_restore, 8, tmp_path, ckpt,
                                 (8, 1), (Shard(0), Replicate()))
    for step, full, placements, local in restored:
        assert step == 5
        assert torch.equal(full, expect)
        assert placements == (Shard(0), Replicate())
        assert local == (1, 8)


def test_elastic_restore_resharding(tmp_path):
    """Checkpoint saved unsharded restores onto any mesh (here: 1 rank with
    explicit placements) — the elastic-scaling path."""
    t = _tree()
    save_checkpoint(str(tmp_path), 3, t)
    mesh = make_host_mesh(1, 1, device_type="cpu")
    try:
        sh = tree.map_tree(lambda _: (Replicate(), Replicate()), t)
        out = load_checkpoint(str(tmp_path), template=t, shardings=sh,
                              mesh=mesh)
        leaf = out["tree"]["layers"]["w"]
        assert isinstance(leaf, DTensor) and leaf.device_mesh == mesh
        assert leaf.placements == (Replicate(), Replicate())
        assert torch.equal(leaf.full_tensor(), t["layers"]["w"])
    finally:
        dist.destroy_process_group()


def test_rules_placements_restore_a_model(tmp_path):
    """A model's params saved from one device restore onto a (1, 1) mesh
    with the rules' placements (``tree_shardings``), every leaf equal; a
    checkpoint of DTensor leaves saves their full values."""
    cfg = get_smoke_config("granite_moe_1b_a400m")
    params = T.init_params(cfg, 0, "cpu")
    mesh = make_host_mesh(1, 1, device_type="cpu")
    try:
        rules = rules_for(cfg, SHAPE_BY_NAME["train_4k"], mesh)
        sh = rules.tree_shardings(T.param_axes(cfg), params)
        save_checkpoint(str(tmp_path), 1, params)
        out = load_checkpoint(str(tmp_path), template=params, shardings=sh,
                              mesh=mesh)["tree"]
        for a, b in zip(tree.leaves(out), tree.leaves(params)):
            assert isinstance(a, DTensor) and a.dtype == b.dtype
            assert torch.equal(a.full_tensor(), b)
        save_checkpoint(str(tmp_path), 2, out)      # DTensor leaves
        again = load_checkpoint(str(tmp_path), template=params)["tree"]
        for a, b in zip(tree.leaves(again), tree.leaves(params)):
            assert not isinstance(a, DTensor) and torch.equal(a, b)
    finally:
        dist.destroy_process_group()
