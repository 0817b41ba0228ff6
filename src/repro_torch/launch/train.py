"""Training launcher on one device: the single-device path of the JAX
package's ``repro.launch.train``.

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
seed 0).  Not ported: ``--dry-run``, ``--stages`` and ``--schedule`` (they
price the step through ``sim.training``), and ``--multi-pod`` and the
production mesh (distribution); they raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.config import SHAPE_BY_NAME, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.data import DataPipeline
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: ModelConfig, *, batch, seq, steps, microbatches=1,
          device="cuda", ckpt_dir=None, ckpt_every=100, resume=False, seed=0,
          log=print):
    """Train ``cfg`` for steps [start, steps): start is 0, or with
    ``resume`` one past the newest checkpoint under ``ckpt_dir``.  Params
    come from ``init_params(cfg, seed, device)``.  Returns a dict:
    ``params``, ``opt``, ``start``, and per step run its ``losses``
    (floats) and ``step_s`` (host clock, device synced)."""
    device = resolve_device(device)
    params, opt = init_train_state(cfg, seed, device)
    step_fn = make_train_step(cfg, TrainConfig(total_steps=steps,
                                               n_microbatches=microbatches))
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    start = 0
    if resume and mgr is not None and mgr.latest_step() is not None:
        out = mgr.restore(template={"params": params, "opt": opt})
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
    finally:
        pipe.stop()
    return {"params": params, "opt": opt, "start": start, "losses": losses,
            "step_s": step_s}


def main(argv=None):
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
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--stages", type=int, default=None)
    ap.add_argument("--schedule", default=None,
                    choices=("gpipe", "1f1b", "both"))
    args = ap.parse_args(argv)

    if args.dry_run or args.stages is not None or args.schedule is not None:
        raise NotImplementedError(
            "--dry-run, --stages and --schedule price the step through the "
            "training simulator, sim/training.py, not yet ported (ROADMAP "
            "Queue 1 item 17)")
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod needs the production mesh, not yet ported (ROADMAP "
            "Queue 1 item 10)")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    shape = SHAPE_BY_NAME[args.shape]
    if args.smoke:
        cfg = get_smoke_config(args.arch)
        batch, seq = 4, 64
    else:
        cfg = get_config(args.arch)
        batch, seq = shape.global_batch, shape.seq_len
    train(cfg, batch=batch, seq=seq, steps=args.steps,
          microbatches=args.microbatches, device=args.device,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          resume=args.resume, seed=args.seed)


if __name__ == "__main__":
    main()
