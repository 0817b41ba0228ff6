"""Multi-rank helpers for the port's distribution tests, on the CPU.

``spawn(fn, world, tmp_path, *args)`` starts ``world`` ranks (spawn start
method, one torch thread each), joins them in a gloo process group on a
``FileStore`` under ``tmp_path`` (no port to collide between the suite's
workers), runs ``fn(rank, world, *args)`` in each and returns what each
rank returned, in rank order.  A rank that raises fails the call with its
traceback; a rank that hangs fails it after ``timeout`` seconds, its
processes killed.  The rank functions live here, not in the test files,
so that the ranks import torch and the port only, never JAX.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world, store_path, out_dir, fn, args, timeout):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, world, tmp_path, *args, timeout=60):
    out_dir = os.path.join(str(tmp_path), f"ranks_{fn.__name__}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    ctx = mp.start_processes(_rank_main, args=(world, store, out_dir, fn,
                                               args, timeout),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: ranks still running "
                                   f"after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@contextlib.contextmanager
def mesh_installed(mesh, rules=None):
    """``mesh`` (and ``rules``) active for the block."""
    from repro_torch.dist import context as dist_ctx
    from repro_torch.dist import sharding
    dist_ctx.set_mesh(mesh)
    sharding.set_active_rules(rules)
    try:
        yield mesh
    finally:
        dist_ctx.set_mesh(None)
        sharding.set_active_rules(None)


# ---------------------------------------------------------------------------
# rank functions


def rank_compress(rank, world, grads, seed):
    """``compressed_psum_grads`` over a (data = world) mesh: this rank's
    grads, its generator at ``seed + rank``.  Also the mesh accessors on
    the real mesh."""
    from repro_torch.dist import compress
    from repro_torch.dist import context as dist_ctx
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world, 1, device_type="cpu")
    with mesh_installed(mesh):
        sizes = (dist_ctx.mesh_axis_size("data"),
                 dist_ctx.mesh_axis_size("model"),
                 dist_ctx.mesh_axis_size("pod"), dist_ctx.dp_axes())
    gen = torch.Generator().manual_seed(seed + rank)
    out, res = compress.compressed_psum_grads(grads[rank], mesh, "data", gen)
    return out, res, sizes


def rank_tp(rank, world, x, w, mlp, flags):
    """``tp_project`` and ``mlp_apply`` with d_ff split over a (1, world)
    mesh's ``model`` ranks, inside a region that binds ``model``, under
    each of ``flags`` (``bf16_tp_collectives``); and ``tp_project`` outside
    one (no reduce)."""
    from repro_torch.dist import context as dist_ctx
    from repro_torch.dist.tp import tp_project
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import mlp_apply
    mesh = make_host_mesh(1, world, device_type="cpu")
    n = w.shape[0] // world
    part = slice(rank * n, (rank + 1) * n)
    local_mlp = {"up": mlp["up"][:, part], "gate": mlp["gate"][:, part],
                 "down": mlp["down"][part]}
    out = {}
    with mesh_installed(mesh):
        out["unbound"] = tp_project(x[..., part], w[part])
        for flag in flags:
            dist_ctx.set_perf_flags(dist_ctx.PerfFlags(
                bf16_tp_collectives=flag))
            with dist_ctx.bound_axes("model"):
                out[flag] = (tp_project(x[..., part], w[part]),
                             mlp_apply(local_mlp, x.to(torch.bfloat16),
                                       "swiglu"))
        dist_ctx.set_perf_flags(dist_ctx.PerfFlags())
    return out


def rank_pipeline(rank, world, ws, x, n_microbatches):
    """``pipeline_apply`` of tanh(x @ w) over a (stage = world) mesh, this
    rank holding its stage's w."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.pipeline import pipeline_apply
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    return pipeline_apply(mesh, lambda w, h: torch.tanh(h @ w), ws[rank], x,
                          n_microbatches)


def rank_moe(rank, world, cfg, params, x, shape):
    """Expert-parallel ``moe_apply`` on a ``shape`` = (data, model) mesh:
    this rank's batch shard of ``x`` in, its output shard and aux out."""
    from repro_torch.dist import context as dist_ctx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    mesh = make_host_mesh(*shape, device_type="cpu")
    with mesh_installed(mesh):
        index, count = dist_ctx.shard_of(dist_ctx.dp_axes())
        xs = x.reshape(count, x.shape[0] // count, *x.shape[1:])[index]
        out, aux = moe.moe_apply(params, xs, cfg)
    return index, out, aux


def rank_train_step(rank, world, cfg, params, batch, shape_name, dtypes,
                    microbatches=1):
    """One data-parallel train step in each of ``dtypes`` on a (world, 1)
    mesh with ``rules_for``'s rules installed: each rank gets the global
    batch.  Returns {dtype: (metrics, the gradients handed to the clip)}."""
    from repro_torch.core.config import SHAPE_BY_NAME
    from repro_torch.dist.sharding import rules_for
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world, 1, device_type="cpu")
    rules = rules_for(cfg, SHAPE_BY_NAME[shape_name], mesh)
    with mesh_installed(mesh, rules):
        return {dtype: train_step_with_grads(cfg, cast(params, dtype), batch,
                                             microbatches)
                for dtype in dtypes}


def cast(params, dtype):
    """A copy of ``params`` (the step updates in place): every leaf in
    float32 for ``dtype`` float32, else each in its own dtype."""
    from repro_torch.core import tree
    if dtype == torch.float32:
        return tree.map_tree(lambda t: t.to(dtype, copy=True), params)
    return tree.map_tree(torch.clone, params)


def train_step_with_grads(cfg, params, batch, microbatches=1):
    """One train step (lr 1e-3, warmup 1, ``microbatches``) of ``params``
    on ``batch``:
    (metrics as floats, the gradients handed to the clip).  Float32 params
    train in float32 throughout: the embedding's bf16 cast is lifted, as
    ``_torch_grads`` lifts it."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train import step as step_mod
    got = []
    clip, embed = step_mod.clip_by_global_norm, T._embed_tokens

    def capture(grads, max_norm):
        got[:] = [g.detach().clone() for g in grads]
        return clip(grads, max_norm)

    def embed_f32(cfg, p, tokens, offset=0):
        x = p["embed"][tokens]
        if cfg.name.startswith("gemma"):
            x = x * cfg.d_model ** 0.5
        return x
    step_mod.clip_by_global_norm = capture
    if params["embed"].dtype == torch.float32:
        T._embed_tokens = embed_f32
    try:
        step = make_train_step(cfg, TrainConfig(
            lr=1e-3, warmup=1, n_microbatches=microbatches))
        _, _, metrics = step(params, adamw_init(params), batch, 1)
    finally:
        step_mod.clip_by_global_norm, T._embed_tokens = clip, embed
    return {k: float(v) for k, v in metrics.items()}, got


def rank_save(rank, world, directory, value, shape, placements):
    """Saves {"w": value} distributed on a ``shape`` = (data, model) mesh
    with ``placements`` at step 5."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(*shape, device_type="cpu")
    w = distribute_tensor(value, mesh, placements)
    save_checkpoint(directory, 5, {"w": w})
    return tuple(w.to_local().shape)


def rank_restore(rank, world, directory, shape, placements):
    """Restores {"w"} onto a ``shape`` = (data, model) mesh with
    ``placements``: (step, full value, placements, local shape)."""
    from repro_torch.ckpt import load_checkpoint
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(*shape, device_type="cpu")
    t = {"w": torch.zeros(8, 8)}
    out = load_checkpoint(directory, template=t,
                          shardings={"w": placements}, mesh=mesh)
    w = out["tree"]["w"]
    return (out["step"], w.full_tensor(), tuple(w.placements),
            tuple(w.to_local().shape))


def rank_smoke_cli(rank, world, steps):
    """``launch.train``'s ``--smoke`` CLI on this rank of a world of
    ``world``, as under ``torchrun``: (the installed rules' ``batch``
    entry, the logged losses)."""
    from repro_torch.dist import sharding
    from repro_torch.launch import train as tlaunch
    os.environ["WORLD_SIZE"] = str(world)
    seen = []
    train = tlaunch.train

    def spy(cfg, **kw):
        seen.append(sharding.active_rules().table["batch"])
        return train(cfg, **kw)
    tlaunch.train = spy
    try:
        out = tlaunch.main(["--smoke", "--device", "cpu", "--steps",
                            str(steps)])
    finally:
        tlaunch.train = train
    return seen, out["losses"]
