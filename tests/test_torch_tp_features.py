"""The pieces of the train step over a ``model`` axis, on the CPU in gloo
process groups (``_torch_dist.spawn``): the differentiable collectives
(the Megatron pairs) forward and backward, the DTensor trees and their
local shards, a rank's matmul FLOPs against one process's, a
model-sharded state saved and resumed against an uninterrupted run
(``launch.train.train`` on a (1, 2) mesh, its moments made from the
shards), the step's refusal of plain tensors on a ``model`` axis, and
``tp.shard_dim``'s of a weight without a shard mark in a ``model``
region.
"""

import numpy as np
import pytest
import torch

import _torch_dist
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic_batch
from repro_torch.dist import context as dist_ctx
from repro_torch.models import transformer as T


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_collectives_forward_and_backward_on_two_ranks(tmp_path):
    """Rank r's input (r + 1) A, A = arange(12) as (3, 4); the loss
    sum(y W), W = arange over y.  Forward and the input's gradient of each
    Function, exactly; reduce_from's backward is the identity, so that
    y -> reduce_from(2 y) gives y.grad 2, not 4."""
    ranks = _torch_dist.spawn(_torch_dist.rank_collectives, 2, tmp_path)
    A = torch.arange(12.0).reshape(3, 4)
    W4, W8, W2 = (torch.arange(float(n)).reshape(3, n // 3)
                  for n in (12, 24, 6))
    for r, out in enumerate(ranks):
        own = slice(2 * r, 2 * r + 2)
        expect = {
            "copy_to": ((r + 1) * A, 2 * W4),
            "reduce_from": (3 * A, W4),
            "gather_from": (torch.cat([A, 2 * A], 1), W8[:, 4 * r:4 * r + 4]),
            "gather_from_reduce_grad": (torch.cat([A, 2 * A], 1),
                                        2 * W8[:, 4 * r:4 * r + 4]),
            "scatter_to": (((r + 1) * A)[:, own], torch.cat([W2, W2], 1)),
            "reduce_scatter_to": ((3 * A)[:, own], torch.cat([W2, W2], 1))}
        for name, (y, grad) in expect.items():
            assert torch.equal(out[name][0], y), name
            assert torch.equal(out[name][1], grad), name
        assert torch.equal(out["reduce_from(2y)"], torch.full((3,), 2.0))
        assert torch.equal(out["max"], torch.tensor([1.0]))
        marks, owns, fulls = out["trees"]
        w, r_ = torch.arange(24.0).reshape(3, 8), \
            torch.arange(24.0).reshape(8, 3)
        assert marks["w"][1] == 1 and torch.equal(
            marks["w"][0], w[:, 4 * r:4 * r + 4] + 1)
        assert marks["r"][1] == 0 and torch.equal(
            marks["r"][0], r_[4 * r:4 * r + 4] + 1)
        assert marks["n"][1] is None and torch.equal(
            marks["n"][0], torch.arange(4.0) + 1)
        assert owns == (True, True)
        assert torch.equal(fulls[0], w + 1) and torch.equal(fulls[1], r_ + 1)
        assert torch.equal(fulls[2], torch.arange(4.0) + 1)


def test_a_rank_does_at_most_0_6_of_one_process_matmul_flops(tmp_path):
    """tinyllama_1_1b's SMOKE step (forward, recompute, backward) on
    (data 1, model 2): every matmul FLOP ``FlopCounterMode`` counts on a
    rank is at most 0.6 of one process's; the heads, ``d_ff`` and vocab
    compute on their shards, not on gathered weights (that would be FSDP,
    and 1.0)."""
    cfg = get_smoke_config("tinyllama_1_1b")
    params = T.init_params(cfg, 1, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        cfg, 4, 16, np.random.default_rng(3)).items()}
    one = sum(_torch_dist.step_flops(cfg, _torch_dist.cast(
        params, torch.bfloat16), batch).values())
    ranks = _torch_dist.spawn(_torch_dist.rank_flops, 2, tmp_path, cfg,
                              params, batch)
    assert one > 0
    for flops in ranks:
        assert sum(flops.values()) <= 0.6 * one, (flops, one)


def test_model_sharded_state_resumes_as_an_uninterrupted_run(tmp_path):
    """``launch.train.train`` on (data 1, model 2) with the rules
    installed: 3 steps at once against 2 steps, a checkpoint (the
    DTensors gathered to full values) and a resume onto the mesh with the
    rules' placements for the third.  The third loss, and every param and
    moment after it, equal bit for bit; each rank holds its shards, and
    ``train`` makes AdamW's moments from the placed shards alone."""
    cfg = get_smoke_config("tinyllama_1_1b")
    ranks = _torch_dist.spawn(_torch_dist.rank_resume, 2, tmp_path, cfg,
                              str(tmp_path / "ckpt"), 4, 16, timeout=120)
    params = T.init_params(cfg, 2, "cpu")
    from repro_torch.core import tree
    full = tree.flatten(params)
    for whole, resumed, start, a, b, dims, shapes, made in ranks:
        # the moments are made on the shards only, never at full size
        assert made == [True] * 3, made
        assert start == 2 and len(whole) == 3 and len(resumed) == 1
        assert resumed[0] == whole[2]
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), key
        assert any(d is not None for d in dims.values())
        for key, d in dims.items():
            expect = list(full[key].shape)
            if d is not None:
                expect[d] //= 2
            assert shapes[key] == tuple(expect), key


def test_step_refuses_plain_tensors_on_a_model_axis():
    """On a mesh whose ``model`` axis is larger than 1 the step takes the
    rules' DTensors (this replaces the refusal of a ``model`` axis)."""
    class FakeMesh:
        shape = {"data": 1, "model": 2}
    cfg = get_smoke_config("tinyllama_1_1b")
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train import make_train_step
    params, opt = init_train_state(cfg, 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        cfg, 2, 8, np.random.default_rng(0)).items()}
    dist_ctx.set_mesh(FakeMesh())
    try:
        with pytest.raises(ValueError, match="DTensors"):
            make_train_step(cfg, TrainConfig())(params, opt, batch, 0)
    finally:
        dist_ctx.set_mesh(None)


def test_an_unmarked_weight_in_a_model_region_raises():
    """Inside a region that binds a ``model`` axis of 2, ``tp.shard_dim``
    reads a leaf's mark (its split dimension, or None for a whole leaf);
    a weight that carries none (a copy or cast of a leaf drops it) raises
    instead of passing this rank's partial product for the whole one.
    Outside the region it is None, marked or not."""
    from repro_torch.dist import tp

    class FakeMesh:
        shape = {"data": 1, "model": 2}
    rows = tp.mark_shard(torch.ones(4, 3), 0)
    whole = tp.mark_shard(torch.ones(3, 3), None)
    dist_ctx.set_mesh(FakeMesh())
    try:
        assert tp.shard_dim(rows) is None and tp.shard_dim(torch.ones(2)) \
            is None
        with dist_ctx.bound_axes("model"):
            assert tp.shard_dim(rows) == 0 and tp.shard_dim(whole) is None
            for copy in (rows.bfloat16(), rows.clone(), rows[:2], rows.T):
                with pytest.raises(ValueError, match="no shard mark"):
                    tp.shard_dim(copy)
            with pytest.raises(ValueError, match="no shard mark"):
                tp.tp_project(torch.ones(2, 4), rows.detach())
    finally:
        dist_ctx.set_mesh(None)


def test_kv_heads_follow_the_rank_query_heads():
    """``attention._kv_of_rank_heads`` on rank 1 of ``model`` 2: the one KV
    head its query heads share, where the KV heads are too few to split
    with them; query heads across KV groups are refused."""
    from repro_torch.models import attention

    class Mesh:
        mesh_dim_names = ("model",)

        def size(self, i):
            return 2

        def get_local_rank(self, name):
            return 1
    # (query heads, KV heads): the KV head rank 1 uses
    cases = {(4, 1): 0, (8, 1): 0, (32, 2): 1, (6, 3): None}
    dist_ctx.set_mesh(Mesh())
    try:
        for (H, Hkv), head in cases.items():
            k = torch.arange(float(Hkv)).reshape(1, Hkv, 1, 1).expand(
                1, Hkv, 2, 3)
            if head is None:
                with pytest.raises(NotImplementedError):
                    attention._kv_of_rank_heads(k, k, H // 2, H)
                continue
            got, _ = attention._kv_of_rank_heads(k, k, H // 2, H)
            assert got[0, :, 0, 0].tolist() == [float(head)]
    finally:
        dist_ctx.set_mesh(None)
