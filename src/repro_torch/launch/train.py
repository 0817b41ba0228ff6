"""Training launcher: the port's copy of the JAX package's
``repro.launch.train``.

``train(cfg, ...)`` runs the loop: params from a seed (or given), AdamW,
the data pipeline's synthetic batches, microbatching, async checkpoints
every ``ckpt_every`` steps and at the end, and ``resume`` from the newest
committed checkpoint.  The CLI takes the reference's flags; without
``--smoke`` it trains the full config at the shape's ``seq_len`` and
``global_batch`` on one device, as the reference's single-host path does:

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \
      --ckpt-dir ckpt --ckpt-every 1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \
      --shape train_4k --steps 4 --microbatches 64

The batch of step i is ``synthetic_batch`` at seed ``seed + i``: the
pipeline runs one worker, so that batches come in seed order and a resumed
run sees the batches an uninterrupted run would (the reference's two
workers may swap neighbours, and its resumed pipeline starts again at
seed 0).

The mesh, as the reference installs it: ``--smoke`` installs a (1, 1)
host mesh (``launch.mesh.make_host_mesh``; a world-1 process group of its
own outside ``torchrun``, and (N, 1) under ``torchrun`` at N ranks) and
``rules_for``'s rules around the loop and clears both after; a (1, 1)
mesh replicates everything, so the losses are those of one device.
Without ``--smoke`` a world of one rank trains on one device; under
``torchrun`` the production mesh is built (16 x 16 ranks; ``--multi-pod``
2 x 16 x 16, which on fewer ranks raises the reference's
``RuntimeError``), and, as the reference's launcher places them with
``jax.device_put``, the params and AdamW's moments are placed by the rules
(``dist.sharding.distribute``): each rank holds its shard of every leaf
the rules split over ``model``, and the step (``train.step``) is tensor-
and data-parallel on the local shards; ``--resume`` restores onto the mesh
with the rules' placements.  A (N, 1) mesh replicates every leaf and the
step is data-parallel.  A multi-rank run on the CPU:

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --smoke --device cpu --steps 3

``--dry-run`` launches nothing: it prices the same (arch x shape x
microbatches) cell through the training simulator
(``repro_torch.sim.training``), the pre-launch sanity check for a
schedule choice: the step time, tokens/s, per-stage utilization and the
pipeline bubble under GPipe and 1F1B at ``--stages`` pipeline stages,
priced on one H100 at its bf16 peak (``dry_run``).  It touches no device
and no tensor:

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --dry-run \
      --stages 2 --microbatches 4
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch.apps.serving import default_config
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.config import SHAPE_BY_NAME, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.data import DataPipeline
from repro_torch.dist import context as dist_ctx
from repro_torch.dist.sharding import (active_rules, distribute, rules_for,
                                       set_active_rules)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: ModelConfig, *, batch, seq, steps, microbatches=1,
          device="cuda", ckpt_dir=None, ckpt_every=100, resume=False, seed=0,
          log=print):
    """Train ``cfg`` for steps [start, steps): start is 0, or with
    ``resume`` one past the newest checkpoint under ``ckpt_dir``.  Params
    come from ``init_params(cfg, seed, device)``; on an installed mesh
    whose ``model`` axis is larger than 1 they and AdamW's moments are
    placed by the active rules (``Rules.tree_shardings``), and a resume
    restores them onto the mesh with those placements.  Returns a dict:
    ``params``, ``opt``, ``start``, and per step run its ``losses``
    (floats) and ``step_s`` (host clock, device synced)."""
    device = resolve_device(device)
    restore = {}
    mesh = dist_ctx.get_mesh()
    if mesh is not None and dist_ctx.model_size() > 1:
        # the reference's device_put of params and moments with the rules'
        # shardings: each rank keeps its shard of every split leaf, and the
        # moments are made on the shards (never at full size)
        params = T.init_params(cfg, seed, device)
        param_sh = active_rules().tree_shardings(T.param_axes(cfg), params)
        params = distribute(params, param_sh, mesh)
        opt = adamw_init(params)
        restore = {"mesh": mesh, "shardings": {
            "params": param_sh,
            "opt": {"m": param_sh, "v": param_sh, "count": None}}}
    else:
        params, opt = init_train_state(cfg, seed, device)
    step_fn = make_train_step(cfg, TrainConfig(total_steps=steps,
                                               n_microbatches=microbatches))
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    start = 0
    if resume and mgr is not None and mgr.latest_step() is not None:
        out = mgr.restore(template={"params": params, "opt": opt}, **restore)
        params, opt = out["tree"]["params"], out["tree"]["opt"]
        start = out["step"] + 1
        log(f"[restore] resumed at step {start}")
    pipe = DataPipeline(cfg, batch, seq, n_workers=1, prefetch=2,
                        seed=seed + start)
    losses, step_s = [], []
    try:
        t0 = time.perf_counter()
        for i in range(start, steps):
            t1 = time.perf_counter()
            b = {k: torch.from_numpy(v).to(device)
                 for k, v in next(pipe).items()}
            params, opt, metrics = step_fn(params, opt, b, i)
            losses.append(float(metrics["loss"]))
            _sync(device)
            step_s.append(time.perf_counter() - t1)
            if i % 10 == 0 or i == steps - 1:
                log(f"step {i} loss={losses[-1]:.3f} "
                    f"({(i - start + 1) * batch * seq / (time.perf_counter() - t0):.0f} tok/s)")
            if mgr is not None and i and i % ckpt_every == 0:
                mgr.save_async(i, {"params": params, "opt": opt})
        if mgr is not None:
            mgr.save_async(steps - 1, {"params": params, "opt": opt})
            mgr.wait()
            if dist.is_initialized() and dist.get_world_size() > 1:
                dist.barrier()   # every rank sees the committed checkpoint
    finally:
        pipe.stop()
    return {"params": params, "opt": opt, "start": start, "losses": losses,
            "step_s": step_s}


def dry_run(arch: str, shape_name: str, *, n_stages: int = 1,
            n_microbatches: int = 1, schedule: str = "both",
            smoke: bool = False, emit=print):
    """Price the (arch x shape x microbatches) training cell through the
    simulator instead of launching it; returns the ``TrainingResult``
    list (one per schedule).

    The price is on one H100 at its dense bf16 peak
    (``apps.serving.default_config()``, 989e12), the type the models
    train in (``bytes_per_param=2``).  It is the counterpart of the
    reference's default, the TPU v5e's bf16 peak; the engine's own
    ``EngineConfig()`` is the CUDA cores' float32 rate, 67e12, and would
    price a bf16 step some 15x slow."""
    from repro_torch.sim.training import SCHEDULES, simulate_training
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    batch, seq = (4, 64) if smoke else (shape.global_batch, shape.seq_len)
    schedules = SCHEDULES if schedule == "both" else (schedule,)
    config = default_config()
    out = []
    for sched in schedules:
        r = simulate_training(cfg, n_stages=n_stages,
                              n_microbatches=n_microbatches,
                              schedule=sched, seq_len=seq,
                              global_batch=batch, config=config)
        out.append(r)
        utils = " ".join(f"{k}={v:.2f}"
                         for k, v in r.per_stage_utilization.items())
        emit(f"[dry-run] {arch}/{shape_name} {sched} p={n_stages} "
             f"m={n_microbatches}: step={r.step_time_s*1e3:.3f}ms "
             f"({r.tokens_per_s:.0f} tok/s) "
             f"bubble={r.bubble_fraction:.3f} "
             f"(bound {r.bubble_bound:.3f}) {utils}")
    return out


def main(argv=None):
    """The CLI; returns ``train``'s dict (None with ``--dry-run``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config at batch 4 x 64 tokens")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; none: no checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dry-run", action="store_true",
                    help="simulate the step instead of launching it")
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stages for --dry-run")
    ap.add_argument("--schedule", default="both",
                    choices=("gpipe", "1f1b", "both"),
                    help="pipeline schedule(s) for --dry-run")
    args = ap.parse_args(argv)

    if args.dry_run:
        dry_run(args.arch, args.shape, n_stages=args.stages,
                n_microbatches=args.microbatches, schedule=args.schedule,
                smoke=args.smoke)
        return
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    shape = SHAPE_BY_NAME[args.shape]
    device = resolve_device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if args.smoke:
        cfg = get_smoke_config(args.arch)
        batch, seq = 4, 64
        # the rules shard what the run holds, not the shape it is cut from
        shape = dataclasses.replace(shape, global_batch=batch, seq_len=seq)
    else:
        cfg = get_config(args.arch)
        batch, seq = shape.global_batch, shape.seq_len
    started = not dist.is_initialized()
    try:
        with installed(_mesh(args, device.type), cfg, shape):
            return train(cfg, batch=batch, seq=seq, steps=args.steps,
                         microbatches=args.microbatches, device=args.device,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         resume=args.resume, seed=args.seed)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _mesh(args, device_type):
    """The launch's mesh: ``--smoke``'s host mesh of the world's ranks
    along ``data``; else the production mesh under ``torchrun`` or with
    ``--multi-pod``, and none (one device) for a world of one rank."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if args.smoke:
        return make_host_mesh(world, 1, device_type=device_type)
    if args.multi_pod or world > 1:
        return make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=device_type)
    return None


@contextlib.contextmanager
def installed(mesh, cfg: ModelConfig, shape):
    """``mesh`` and ``rules_for(cfg, shape, mesh)`` installed for the block
    (nothing with no mesh), both cleared after."""
    if mesh is None:
        yield
        return
    set_active_rules(rules_for(cfg, shape, mesh))
    dist_ctx.set_mesh(mesh)
    try:
        yield
    finally:
        set_active_rules(None)
        dist_ctx.set_mesh(None)


if __name__ == "__main__":
    main()
