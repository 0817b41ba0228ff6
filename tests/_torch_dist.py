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
    mesh's ``model`` ranks (each slice marked as this rank's shard),
    inside a region that binds ``model``, under each of ``flags``
    (``bf16_tp_collectives``); and ``tp_project`` outside one (no
    reduce)."""
    from repro_torch.dist import context as dist_ctx
    from repro_torch.dist.tp import mark_shard, tp_project
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import mlp_apply
    mesh = make_host_mesh(1, world, device_type="cpu")
    n = w.shape[0] // world
    part = slice(rank * n, (rank + 1) * n)
    local_mlp = {"up": mark_shard(mlp["up"][:, part], 1),
                 "gate": mark_shard(mlp["gate"][:, part], 1),
                 "down": mark_shard(mlp["down"][part], 0)}
    w = mark_shard(w[part], 0)
    out = {}
    with mesh_installed(mesh):
        out["unbound"] = tp_project(x[..., part], w)
        for flag in flags:
            dist_ctx.set_perf_flags(dist_ctx.PerfFlags(
                bf16_tp_collectives=flag))
            with dist_ctx.bound_axes("model"):
                out[flag] = (tp_project(x[..., part], w),
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


@contextlib.contextmanager
def captured_experts():
    """The experts (T, k) each call of the MoE's router chose in the block,
    in call order (forward, then the backward's recomputes)."""
    from repro_torch.models import moe
    chosen, probs = [], moe._probs

    def capture(x32, router_w, top_k):
        out = probs(x32, router_w, top_k)
        chosen.append(out[3].clone())
        return out
    moe._probs = capture
    try:
        yield chosen
    finally:
        moe._probs = probs


@contextlib.contextmanager
def forced_experts(chosen, shard=(0, 1)):
    """The MoE's router choosing, call after call, the experts of
    ``chosen`` (another run's, on the global batch): of each, the rows of
    this rank's ``shard`` = (index, count) of the tokens.  The
    probabilities, and so the combine weights gathered at those experts
    and renormalised, are this run's own.  Routing is discontinuous: a
    bf16 rounding of the partial sums of a row-parallel product can flip
    a near-tie between experts."""
    from repro_torch.models import moe
    probs, it = moe._probs, iter(chosen)
    index, count = shard

    def forced(x32, router_w, top_k):
        logits, p, _, _ = probs(x32, router_w, top_k)
        idx = next(it)
        n = idx.shape[0] // count
        idx = idx[index * n:(index + 1) * n]
        w = p.gather(1, idx)
        return logits, p, w / torch.clamp(w.sum(-1, keepdim=True),
                                          min=1e-9), idx
    moe._probs = forced
    try:
        yield
    finally:
        moe._probs = probs


@contextlib.contextmanager
def counted_collectives():
    """{kind: calls} of the port's all-gathers and reduce-scatters
    (``dist.context``) in the block."""
    from repro_torch.dist import context as dist_ctx
    calls = {}
    saved = {name: getattr(dist_ctx, name)
             for name in ("_all_gather", "_reduce_scatter")}

    def counting(name):
        def fn(*args):
            calls[name] = calls.get(name, 0) + 1
            return saved[name](*args)
        return fn
    for name in saved:
        setattr(dist_ctx, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist_ctx, name, fn)


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
    return train_step_state(cfg, params, batch, microbatches)[:2]


def train_step_state(cfg, params, batch, microbatches=1):
    """``train_step_with_grads`` and the optimizer state after it: (metrics,
    gradients, opt).  ``params`` (plain tensors, or the rules' DTensors on a
    ``model`` axis) are updated in place."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train import step as step_mod
    got = []
    clip, embed = step_mod.clip_by_global_norm, T._embed_tokens

    def capture(grads, max_norm, **kw):
        got[:] = [g.detach().clone() for g in grads]
        return clip(grads, max_norm, **kw)

    def embed_f32(cfg, p, tokens, offset=0):
        x = T._token_rows(p["embed"], tokens)
        if cfg.name.startswith("gemma"):
            x = x * cfg.d_model ** 0.5
        return x
    step_mod.clip_by_global_norm = capture
    if params["embed"].dtype == torch.float32:
        T._embed_tokens = embed_f32
    try:
        step = make_train_step(cfg, TrainConfig(
            lr=1e-3, warmup=1, n_microbatches=microbatches))
        opt = adamw_init(params)
        _, _, metrics = step(params, opt, batch, 1)
    finally:
        step_mod.clip_by_global_norm, T._embed_tokens = clip, embed
    return {k: float(v) for k, v in metrics.items()}, got, opt


def rank_tp_step(rank, world, cfg, params, batch, shape, dtypes,
                 microbatches=1, flags=None, routes=None, device_type="cpu"):
    """One train step in each of ``dtypes`` on a ``shape`` = (data, model)
    mesh with ``rules_for``'s rules (at train_4k) installed and ``flags``
    (``PerfFlags``) set, the params placed by the rules as DTensors; each
    rank gets the global batch.  ``routes``: None or {dtype: the experts
    one process chose on the global batch, call by call}, which the MoE
    then takes (``forced_experts``).  Returns {dtype: dict(metrics, grads:
    the local gradients handed to the clip in leaf order, params / m / v:
    {leaf key: its local shard after the step}, dims: {leaf key: the
    dimension it is split along over ``model``, or None}, model_index,
    collectives)}."""
    from repro_torch.core import tree
    from repro_torch.core.config import SHAPE_BY_NAME
    from repro_torch.dist import context as dist_ctx
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    mesh = make_host_mesh(*shape, device_type=device_type)
    rules = sharding.rules_for(cfg, SHAPE_BY_NAME["train_4k"], mesh)
    out = {}
    with mesh_installed(mesh, rules), counted_collectives() as calls:
        dist_ctx.set_perf_flags(flags or dist_ctx.PerfFlags())
        try:
            for dtype in dtypes:
                full = cast(params, dtype)
                placements = rules.tree_shardings(T.param_axes(cfg), full)
                dparams = sharding.distribute(full, placements, mesh)
                calls.clear()
                forced = contextlib.nullcontext() \
                    if (routes or {}).get(dtype) is None else \
                    forced_experts(routes[dtype],
                                   dist_ctx.shard_of(dist_ctx.dp_axes()))
                with forced:
                    metrics, grads, opt = train_step_state(
                        cfg, dparams, batch, microbatches)

                def local(t):
                    return {k: v.detach().clone() for k, v in tree.flatten(
                        sharding.local_shards(t)).items()}
                out[dtype] = {
                    "metrics": metrics, "grads": grads,
                    "params": local(dparams), "m": local(opt["m"]),
                    "v": local(opt["v"]),
                    "dims": {k: sharding.sharded_dim(pl, "model", mesh)
                             for k, pl in tree.flatten(
                                 placements, containers=list).items()},
                    "model_index": dist_ctx.model_rank(),
                    "collectives": dict(calls)}
        finally:
            dist_ctx.set_perf_flags(dist_ctx.PerfFlags())
    return out


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


def one_process(cfg, params, batch, dtypes, microbatches=1):
    """One process's train step on the whole batch in each of ``dtypes``:
    {dtype: (metrics, gradients, {key: updated param}, {key: m}, {key: v},
    the experts its MoE chose call by call, {key: param before the
    step})}."""
    from repro_torch.core import tree
    out = {}
    for dtype in dtypes:
        full = cast(params, dtype)
        before = {k: v.clone() for k, v in tree.flatten(full).items()}
        with captured_experts() as chosen:
            metrics, grads, opt = train_step_state(cfg, full, batch,
                                                   microbatches)
        out[dtype] = (metrics, grads, tree.flatten(full),
                      tree.flatten(opt["m"]), tree.flatten(opt["v"]),
                      chosen, before)
    return out


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# of lr, what two float32 evaluations of AdamW's step (the card's, and
# ``adamw_first_step``'s on the host) may part by beyond the rounding of
# the param: a few float32 ulps of the update; a missed update is off by 1
STEP_ATOL = 1e-6


def adamw_first_step(old, m, v, lr, weight_decay=0.1, b1=0.9, b2=0.95,
                     eps=1e-8):
    """``old`` after AdamW's first step (count 1) from its moments after
    that step, in ``optim.adamw_update``'s operations."""
    c = torch.ones((), device=old.device)
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
    p32 = old.float()
    step = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p32
    return (p32 - lr * step).to(old.dtype)


def assert_tp_matches(ranks, single, dtype, model, tol, grad_tol, lr=1e-3):
    """Each rank's step (``rank_tp_step``) against one process's
    (``one_process``) in ``dtype``, on a mesh of ``model`` ranks along
    ``model``: the metrics within ``tol`` (relative), every leaf's
    gradient, ``m`` and sqrt(``v``) shard against the slice of one
    process's at relative L2 ``grad_tol`` (``v`` is the square of a
    gradient), every updated param shard within one step of its dtype of
    AdamW's first step from the rank's own ``m`` and ``v``
    (``adamw_first_step``: a missed update, one of the wrong sign or a
    shard that is not the DTensor's storage is off by lr or 2 lr) and
    within 2.5 lr plus one step of its dtype at the leaf's largest value of
    one process's (AdamW's first step moves an element by about lr, either
    sign where its gradient is near 0), and each split leaf held as its
    shard only.  Returns the largest gradient error and the set of split
    leaves' keys."""
    metrics, grads, params, m, v, _, before = single
    ulp = 2 ** -8 if dtype == torch.bfloat16 else 2 ** -23
    worst, split = 0.0, set()
    for r in ranks:
        got = r[dtype]
        for key in ("loss", "nll", "zloss", "moe_loss", "grad_norm"):
            assert abs(got["metrics"][key] - metrics[key]) \
                <= tol * abs(metrics[key]) + 1e-6, \
                (dtype, key, got["metrics"][key], metrics[key])
        assert len(got["grads"]) == len(grads)
        for (key, full), g, ge in zip(params.items(), got["grads"], grads):
            d = got["dims"][key]

            def mine(t):
                if d is None:
                    return t
                n = t.shape[d] // model
                return t.narrow(d, got["model_index"] * n, n)
            local = got["params"][key]
            if d is not None:
                split.add(key)
                assert local.shape[d] * model == full.shape[d], key
            assert local.shape == mine(full).shape, key
            assert g.dtype == ge.dtype, key
            errs = (_rel_l2(g, mine(ge)),
                    _rel_l2(got["m"][key], mine(m[key])),
                    _rel_l2(got["v"][key].sqrt(), mine(v[key]).sqrt()))
            assert max(errs) <= grad_tol, (dtype, key, errs)
            worst = max(worst, *errs)
            stepped = adamw_first_step(mine(before[key]), got["m"][key],
                                       got["v"][key], lr).float()
            off = float(((local.float() - stepped).abs()
                         - torch.finfo(local.dtype).eps * stepped.abs()
                         - STEP_ATOL * lr).max())
            assert off <= 0, (dtype, key, off)
            expect = mine(full).detach().float()
            bound = 2.5 * lr + ulp * float(expect.abs().max())
            err = float((local.float() - expect).abs().max())
            assert err <= bound, (dtype, key, err, bound)
    return worst, split


def tp_case(cfg, params, batch, shape, dtypes, tmp_path, microbatches=1,
            flags=None):
    """One process's step and ``rank_tp_step`` on a ``shape`` = (data,
    model) mesh, in each of ``dtypes``: (ranks, one process).  A MoE arch's
    ranks take one process's experts in bf16 (``forced_experts``); float32
    routes free."""
    single = one_process(cfg, params, batch, dtypes, microbatches)
    routes = {torch.bfloat16: single[torch.bfloat16][5]} \
        if cfg.moe is not None and torch.bfloat16 in dtypes else None
    ranks = spawn(rank_tp_step, shape[0] * shape[1], tmp_path, cfg, params,
                  batch, shape, dtypes, microbatches, flags, routes,
                  timeout=120)
    return ranks, single


def expected_split(cfg):
    """The logical axes the rules split over ``model`` at 2 for every SMOKE
    config: vocab, and the family's heads, ``d_ff``, experts, ``d_inner``."""
    axes = {"vocab"}
    if cfg.family != "ssm":
        axes.add("heads_x_dim")
    if cfg.family != "ssm" and (cfg.moe is None or cfg.moe.n_shared):
        axes.add("d_ff")
    if cfg.moe is not None:
        axes.add("experts")
    if cfg.ssm is not None:
        axes.add("d_inner")
    return axes


def split_axes(cfg, dims):
    """The logical axes of the dimensions ``dims`` ({leaf key: split dim or
    None}) splits."""
    from repro_torch.core import tree
    from repro_torch.models import transformer as T
    axes = tree.flatten(T.param_axes(cfg), containers=list)
    return {axes[k][d] for k, d in dims.items() if d is not None}


def rank_tp_flags(rank, world, cfg, params, batch, flag_sets, dtypes):
    """``rank_tp_step`` on a (1, world) mesh under each ``PerfFlags`` of
    ``flag_sets``, in turn."""
    return [rank_tp_step(rank, world, cfg, params, batch, (1, world), dtypes,
                         1, flags) for flags in flag_sets]


def rank_flops(rank, world, cfg, params, batch):
    """The FLOPs ``torch.utils.flop_counter`` counts in one train step
    (forward, the checkpoints' recompute, backward) of this rank on a (1,
    world) mesh with the rules' shards: {op: flops}."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core.config import SHAPE_BY_NAME
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    mesh = make_host_mesh(1, world, device_type="cpu")
    rules = sharding.rules_for(cfg, SHAPE_BY_NAME["train_4k"], mesh)
    with mesh_installed(mesh, rules):
        dparams = sharding.distribute(
            params, rules.tree_shardings(T.param_axes(cfg), params), mesh)
        with FlopCounterMode(display=False) as counter:
            train_step_state(cfg, dparams, batch)
    return {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}


def step_flops(cfg, params, batch):
    """``rank_flops`` of one process off a mesh."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        train_step_state(cfg, params, batch)
    return {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}


def rank_resume(rank, world, cfg, directory, batch, seq):
    """``launch.train.train`` on a (1, world) mesh with ``rules_for``'s
    rules (``launch.train.installed``): 3 steps at once, then 2 steps with
    a checkpoint under ``directory`` and a resume for the third.  Returns
    (losses of both runs, the resumed run's start, {key: full value} of
    both runs' params and moments after the last step, the placements'
    split dims, this rank's shard shapes, for each ``adamw_init`` that
    ``train`` made whether it took DTensors only)."""
    from repro_torch.core import tree
    from repro_torch.core.config import SHAPE_BY_NAME
    from repro_torch.dist import sharding
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, world, device_type="cpu")
    kw = dict(batch=batch, seq=seq, device="cpu", seed=2, log=lambda *a: None)

    def state(out):
        return {k: v.full_tensor() for k, v in tree.flatten(
            {"params": out["params"], "m": out["opt"]["m"],
             "v": out["opt"]["v"]}).items()}
    made, init = [], tlaunch.adamw_init

    def spy(params):
        made.append(all(sharding.is_dtensor(t) for t in tree.leaves(params)))
        return init(params)
    tlaunch.adamw_init = spy
    tlaunch.init_train_state = None     # makes full-size moments
    with tlaunch.installed(mesh, cfg, SHAPE_BY_NAME["train_4k"]):
        whole = tlaunch.train(cfg, steps=3, **kw)
        tlaunch.train(cfg, steps=2, ckpt_dir=directory, ckpt_every=100, **kw)
        resumed = tlaunch.train(cfg, steps=3, ckpt_dir=directory,
                                resume=True, **kw)
        dims = {k: sharding.sharded_dim(v.placements, "model", mesh)
                for k, v in tree.flatten(resumed["params"]).items()}
        shapes = {k: tuple(v.to_local().shape)
                  for k, v in tree.flatten(resumed["params"]).items()}
    return (whole["losses"], resumed["losses"], resumed["start"],
            state(whole), state(resumed), dims, shapes, made)


def rank_collectives(rank, world):
    """Each of ``dist.context``'s differentiable collectives over a (1,
    world) mesh's ``model`` axis, forward and backward, on this rank's
    input ``(rank + 1) * arange``: {name: (output, input's gradient)} for
    the gradient of sum(output * weight), weight ``arange`` over the
    output; and y -> reduce_from(2 y)'s gradient."""
    from repro_torch.dist import context as dist_ctx
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, world, device_type="cpu")
    fns = {"copy_to": lambda x: dist_ctx.copy_to(x),
           "reduce_from": lambda x: dist_ctx.reduce_from(x),
           "gather_from": lambda x: dist_ctx.gather_from(x, dim=1),
           "gather_from_reduce_grad": lambda x: dist_ctx.gather_from(
               x, dim=1, reduce_grad=True),
           "scatter_to": lambda x: dist_ctx.scatter_to(x, dim=1),
           "reduce_scatter_to": lambda x: dist_ctx.reduce_scatter_to(
               x, dim=1)}
    out = {}
    with mesh_installed(mesh):
        for name, fn in fns.items():
            x = ((rank + 1) * torch.arange(12.0).reshape(3, 4)) \
                .requires_grad_(True)
            y = fn(x)
            w = torch.arange(float(y.numel())).reshape(y.shape)
            (y * w).sum().backward()
            out[name] = (y.detach(), x.grad)
        y = torch.ones(3, requires_grad=True)
        dist_ctx.reduce_from(2 * y).sum().backward()
        out["reduce_from(2y)"] = y.grad
        out["max"] = dist_ctx.all_reduce(torch.tensor([float(rank)]),
                                         "model", op="max")
        out["trees"] = _tree_round_trip(mesh)
    return out


def _tree_round_trip(mesh):
    """``sharding.distribute`` -> ``local_shards`` of a tree with a leaf
    split over ``model`` along dim 1, one along dim 0 and a replicated
    one: (the local shards, each after an in-place ``add_(1)``, and their
    marks; whether each split shard holds storage of its own, not a view
    of the whole leaf; the DTensors' full values after the update)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist import sharding
    from repro_torch.dist.tp import marked_dim
    full = {"w": torch.arange(24.0).reshape(3, 8),
            "r": torch.arange(24.0).reshape(8, 3),
            "n": [torch.arange(4.0)]}
    shardings = {"w": (Replicate(), Shard(1)), "r": (Replicate(), Shard(0)),
                 "n": [(Replicate(),) * 2]}
    dt = sharding.distribute(full, shardings, mesh)
    local = sharding.local_shards(dt)
    for t in (local["w"], local["r"], local["n"][0]):
        t.add_(1)                 # the same storage as the DTensor's

    def own(t):
        return t.untyped_storage().nbytes() == t.numel() * t.element_size()
    return ({k: (t, marked_dim(t)) for k, t in (
                ("w", local["w"]), ("r", local["r"]), ("n", local["n"][0]))},
            (own(local["w"]), own(local["r"])),
            (dt["w"].full_tensor(), dt["r"].full_tensor(),
             dt["n"][0].full_tensor()))


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def rank_tp_card(rank, world, arch, n_layers, B, S):
    """On the card (a gloo group, the tensors CUDA): ``arch``'s full config
    cut to ``n_layers`` at full width, params from seed 1 made on the card
    (the same on every rank), one process's bf16 step on a B x S batch
    (``one_process``) and the step on a (1, world) mesh (``rank_tp_step``),
    the kernel counts set to 0 just before the latter and read just after:
    (rank_tp_step's dict, one_process's, (flash launches, scan launches)),
    on the host."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models import transformer as T
    torch.cuda.set_device(0)
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    params = T.init_params(cfg, 1, "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        cfg, B, S, np.random.default_rng(3)).items()}
    single = one_process(cfg, params, batch, (torch.bfloat16,))
    fa.reset_counts()
    ms.mamba_scan.launches = 0
    out = rank_tp_step(rank, world, cfg, params, batch, (1, world),
                       (torch.bfloat16,), device_type="cuda")
    launches = (fa.flash_attention.launches, ms.mamba_scan.launches)
    return _to_cpu(out), _to_cpu(single), launches


# ---------------------------------------------------------------------------
# the serving steps on the rules' shards


@contextlib.contextmanager
def lifted_embedding(dtype):
    """For float32 params the embedding's bf16 cast lifted (as
    ``train_step_state`` lifts it), so that the model runs in float32."""
    from repro_torch.models import transformer as T
    embed = T._embed_tokens

    def embed_f32(cfg, p, tokens, offset=0):
        x = T._token_rows(p["embed"], tokens)
        if cfg.name.startswith("gemma"):
            x = x * cfg.d_model ** 0.5
        return x
    if dtype == torch.float32:
        T._embed_tokens = embed_f32
    try:
        yield
    finally:
        T._embed_tokens = embed


def serve_inputs(cfg, B, S, steps, seed=5):
    """(prompt tokens (B, S), the teacher-forced tokens (B, steps)) from
    ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (B, S), generator=g), \
        torch.randint(0, cfg.vocab, (B, steps), generator=g)


def serve_run(cfg, params, B, S, steps, dtype, routes=None, shard=(0, 1)):
    """Prefill of ``serve_inputs``' prompts, then ``steps`` decode steps
    teacher-forced on its tokens, through ``serve.step`` (on the rules'
    shards where a mesh and rules are installed): (the float32 logits of
    the prefill and of each step, whole; each step's greedy tokens; the
    cache).  ``routes``: the experts another run's MoE chose, forced
    (``forced_experts``)."""
    from repro_torch.serve import step as st
    toks, forced = serve_inputs(cfg, B, S, steps)
    pos = st.prompt_positions(cfg, S)
    pre = st.make_prefill_step(cfg, pos + steps)
    dec = st.make_decode_step(cfg)

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).float()
    force = contextlib.nullcontext() if routes is None \
        else forced_experts(routes, shard)
    with lifted_embedding(dtype), force:
        lg, cache = pre(params, st.prefill_inputs(cfg, toks))
        logits, tokens = [whole(lg)], []
        for i in range(steps):
            nxt, cache, lg = dec(params, cache, forced[:, i:i + 1], pos + i)
            logits.append(whole(lg))
            tokens.append(nxt.clone())
    return logits, tokens, cache


def _shard_offsets(t):
    """The global offset of each dimension of a DTensor's local shard."""
    mesh, local = t.device_mesh, t.to_local()
    idx = [0] * t.dim()
    for i, p in enumerate(t.placements):
        if p.is_shard():
            idx[p.dim] = idx[p.dim] * mesh.size(i) + mesh.get_local_rank(i)
    return [i * n for i, n in zip(idx, local.shape)]


@contextlib.contextmanager
def windowed(on=True):
    """``PerfFlags.windowed_attention`` in force for the block where
    ``on``: a local layer's decode reads only its window's slice of the
    cache."""
    import dataclasses
    from repro_torch.dist import context as dist_ctx
    before = dist_ctx.perf_flags()
    if on:
        dist_ctx.set_perf_flags(dataclasses.replace(
            before, windowed_attention=True))
    try:
        yield
    finally:
        dist_ctx.set_perf_flags(before)


@contextlib.contextmanager
def conv_cache_f32(on=True):
    """The port's Mamba ``conv`` cache made in float32 (it is bf16) for the
    block where ``on``."""
    from repro_torch.models import transformer as T
    init = T.init_cache

    def init_f32(*args, **kw):
        cache = init(*args, **kw)
        if "conv" in cache:
            cache["conv"] = cache["conv"].float()
        return cache
    if on:
        T.init_cache = init_f32
    try:
        yield
    finally:
        T.init_cache = init


def rank_serve(rank, world, cases, shape, window=False, conv_f32=False):
    """The serving steps (``serve_run``) of each case = (arch, dtype, B, S,
    steps, routes) on a ``shape`` = (data, model) mesh with ``rules_for``'s
    rules at a decode shape of the case's batch and positions installed,
    the params the rules' DTensors where ``model`` > 1, under
    ``windowed(window)`` and ``conv_cache_f32(conv_f32)``.  Returns {(arch, dtype, B): dict(logits, tokens,
    cache: {key: (local shard, offsets)}, table: the rules' table)}."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.config import ShapeConfig
    from repro_torch.dist import context as dist_ctx
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serve import step as st
    mesh = make_host_mesh(*shape, device_type="cpu")
    out = {}
    for arch, dtype, B, S, steps, routes in cases:
        cfg = get_smoke_config(arch)
        params = cast(T.init_params(cfg, 1, "cpu"), dtype)
        max_seq = st.prompt_positions(cfg, S) + steps
        rules = sharding.rules_for(cfg, ShapeConfig(
            "serve", seq_len=max_seq, global_batch=B, kind="decode"), mesh)
        with mesh_installed(mesh, rules), windowed(window), \
                conv_cache_f32(conv_f32):
            if dist_ctx.model_size() > 1:
                params = sharding.distribute(params, rules.tree_shardings(
                    T.param_axes(cfg), params), mesh)
            logits, tokens, cache = serve_run(
                cfg, params, B, S, steps, dtype, routes,
                dist_ctx.shard_of(rules.table.get("batch")))
            out[(arch, dtype, B)] = {
                "logits": logits, "tokens": tokens,
                "cache": {k: (v.to_local().clone(), _shard_offsets(v))
                          for k, v in cache.items()},
                "table": dict(rules.table)}
    return out


def rank_greedy(rank, world, rows):
    """``serve.step.greedy_vocab_parallel`` of ``rows`` (B, V), this rank
    holding its 1/world of the vocab, on a (1, world) mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import step as st
    mesh = make_host_mesh(1, world, device_type="cpu")
    with mesh_installed(mesh):
        V = rows.shape[1] // world
        return st.greedy_vocab_parallel(rows[:, None, rank * V:(rank + 1) * V])
