"""Pipeline and expert parallelism, and the data-parallel train step, on
the port held against sequential runs and against the JAX package, on the
CPU, in gloo process groups of 2 and 4 ranks (``_torch_dist.spawn``).

Mirrors ``tests/test_pipeline.py:23-73`` (GPipe on 4 stages at 1e-5; EP on
a 2 x 2 mesh at 0.05) and ``tests/test_training.py:362``
(``stage_layer_slices``); the EP output is also held against the
reference's single-device ``moe_apply`` on the same params.  A 2-rank
data-parallel train step is held against one rank on the global batch:
loss and grad norm at 2e-2 and every gradient leaf at 3e-2 relative L2 in bf16,
all at 1e-4 in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro.configs import get_smoke_config as j_smoke
from repro.models import moe as JM
from repro.models.layers import split_leaves
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic_batch
from repro_torch.dist.pipeline import (partition_stages, pipeline_apply,
                                       stage_layer_slices)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as T


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stage_fn(w, x):
    return torch.tanh(x @ w)


def test_gpipe_matches_sequential(tmp_path):
    S, B, D = 4, 8, 16
    gen = torch.Generator().manual_seed(0)
    ws = torch.randn(S, D, D, generator=gen) * 0.3
    x = torch.randn(B, D, generator=gen)
    y_seq = x
    for i in range(S):
        y_seq = _stage_fn(ws[i], y_seq)
    for y_pipe in _torch_dist.spawn(_torch_dist.rank_pipeline, S, tmp_path,
                                    ws, x, 4):
        err = float((y_pipe - y_seq).abs().max())
        assert err < 1e-5, err


def test_one_stage_pipeline_is_a_local_copy():
    """One stage: the rotation to itself is a local copy, and the result is
    the stage applied once (a world-1 group, no send)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("stage",))
        gen = torch.Generator().manual_seed(1)
        w, x = torch.randn(8, 8, generator=gen), torch.randn(6, 8,
                                                             generator=gen)
        assert torch.equal(pipeline_apply(mesh, _stage_fn, w, x, 3),
                           _stage_fn(w, x))
    finally:
        dist.destroy_process_group()


def test_stage_layer_slices_match_partition():
    assert stage_layer_slices(18, 4) == [(0, 5), (5, 10), (10, 14),
                                         (14, 18)]
    for n, p in ((16, 4), (22, 8), (7, 7)):
        slices = stage_layer_slices(n, p)
        assert [hi - lo for lo, hi in slices] == list(partition_stages(n, p))
        assert slices[0][0] == 0 and slices[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))


def test_moe_ep_matches_single_device(tmp_path):
    """EP over a (data 2, model 2) mesh, each rank its batch shard and 2 of
    the 4 experts, == the single-shard MoE: the port's and the reference's
    on the same params, at the reference test's 0.05."""
    jcfg = j_smoke("granite_moe_1b_a400m")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=8.0))
    cfg = get_smoke_config("granite_moe_1b_a400m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    jp, _ = split_leaves(JM.moe_init(jax.random.PRNGKey(0), jcfg))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, jcfg.d_model)
                          ).astype(jnp.bfloat16)
    ref, _ = JM.moe_apply(jp, x, jcfg)
    ref = np.asarray(ref.astype(jnp.float32))
    p = convert.tree_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)
    single, aux = moe.moe_apply(p, tx, cfg)
    ranks = _torch_dist.spawn(_torch_dist.rank_moe, 4, tmp_path, cfg, p, tx,
                              (2, 2))
    assert sorted(r[0] for r in ranks) == [0, 0, 1, 1]
    out = torch.cat([next(r[1] for r in ranks if r[0] == i)
                     for i in range(2)]).float()
    for expect in (single.float().numpy(), ref):
        err = float(np.abs(out.numpy() - expect).max())
        assert err < 0.05, err
    # the ranks of one model pair agree, and the aux terms are replicated
    for a in ranks:
        for b in ranks:
            if a[0] == b[0]:
                assert torch.equal(a[1], b[1])
            for k in ("load_balance", "router_z"):
                assert torch.equal(a[2][k], b[2][k])


def test_moe_off_a_mesh_or_at_model_1_is_single_shard():
    cfg = get_smoke_config("granite_moe_1b_a400m")
    p = T.init_params(cfg, 0, "cpu")["layers"][0]["moe"]
    x = torch.randn(2, 8, cfg.d_model).to(torch.bfloat16)
    single, _ = moe.moe_apply(p, x, cfg)
    import torch.distributed as dist
    mesh = make_host_mesh(1, 1, device_type="cpu")
    try:
        with _torch_dist.mesh_installed(mesh):
            assert torch.equal(moe.moe_apply(p, x, cfg)[0], single)
    finally:
        dist.destroy_process_group()


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("arch, microbatches", [
    ("tinyllama_1_1b", 1), ("granite_moe_1b_a400m", 1),
    ("granite_moe_1b_a400m", 2)])
def test_data_parallel_step_matches_one_rank(tmp_path, arch, microbatches):
    """A train step on a (data 2, model 1) mesh, each rank taking its half
    of the global batch by the rules, against one rank (no mesh) on the
    whole batch.  The MoE family's expert capacity, slot order and aux
    terms are the global batch's on every rank, as the reference's jit
    computes them at a ``model`` axis of 1; with microbatches, of each
    global microbatch."""
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, 1, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        cfg, 4, 16, np.random.default_rng(3)).items()}
    dtypes = (torch.bfloat16, torch.float32)
    ranks = _torch_dist.spawn(_torch_dist.rank_train_step, 2, tmp_path, cfg,
                              params, batch, "train_4k", dtypes,
                              microbatches)
    for dtype in dtypes:
        metrics, grads = _torch_dist.train_step_with_grads(
            cfg, _torch_dist.cast(params, dtype), batch, microbatches)
        tol, grad_tol = (2e-2, 3e-2) if dtype == torch.bfloat16 \
            else (1e-4, 1e-4)
        for got, got_grads in (r[dtype] for r in ranks):
            for key in ("loss", "nll", "zloss", "moe_loss", "grad_norm"):
                assert abs(got[key] - metrics[key]) \
                    <= tol * abs(metrics[key]) + 1e-6, (dtype, key)
            assert len(got_grads) == len(grads)
            for g, e in zip(got_grads, grads):
                assert g.dtype == e.dtype
                assert _rel_l2(g, e) <= grad_tol, dtype
        assert all(torch.equal(a, b) for a, b in
                   zip(ranks[0][dtype][1], ranks[1][dtype][1]))
