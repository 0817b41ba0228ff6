"""End-to-end training driver: data pipeline -> train step -> async
checkpointing -> restart/restore, on the card.

The port's counterpart of ``examples/train_lm.py``, with its flags, defaults
and printed lines.  ``--preset cpu-small`` is a ~5M-param config that trains
in CPU minutes (``--device cpu``); ``--preset full`` is the arch's registry
config (tinyllama_1_1b: 22 layers, d_model 2048, 1.1B params) for the card.
The step is ``repro_torch.train.make_train_step``'s eager step, which
updates the params and AdamW's moments in place; a checkpoint is copied to
the host before ``save_async`` returns, so the next step cannot tear it.

As the reference's, the pipeline's two workers do not fix the order of the
batches, and a resumed run's pipeline starts again at seed 0; ``run`` takes
any iterator of batches.

  PYTHONPATH=src python examples_torch/train_lm.py --steps 60 \\
      --preset cpu-small --device cpu
  PYTHONPATH=src python examples_torch/train_lm.py --preset full --steps 4
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import tree
from repro_torch.core.device import resolve_device
from repro_torch.data import DataPipeline
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def preset_config(arch, preset):
    cfg = (get_smoke_config(arch) if preset == "cpu-small"
           else get_config(arch))
    # a ~5M-param config that actually trains in CPU minutes
    if preset == "cpu-small":
        cfg = dataclasses.replace(cfg, n_layers=4, d_model=256, n_heads=8,
                                  n_kv_heads=4, d_ff=704, vocab=2048)
    return cfg


def restore(mgr, params, opt, log=print):
    """The newest checkpoint under ``mgr`` in the structure and on the
    device of ``params`` and ``opt``; returns (params, opt, next step)."""
    out = mgr.restore(template={"params": params, "opt": opt})
    log(f"resumed from step {out['step']}")
    return out["tree"]["params"], out["tree"]["opt"], out["step"] + 1


def run(cfg, tc, params, opt, batches, start, steps, mgr=None,
        ckpt_every=50, log=print):
    """Steps [start, steps) of ``make_train_step(cfg, tc)`` on ``batches``
    (an iterator of dicts of arrays, moved to the params' device), with
    ``mgr.save_async`` every ``ckpt_every`` steps and at the last step,
    then ``mgr.wait()``.  Returns a dict: ``params``, ``opt``, and per step
    run its ``losses``, ``gnorms``, ``lrs`` (floats) and ``step_s`` (host
    clock; the loss's copy to the host syncs the device); ``save_s``, the
    last save's seconds (its host copy and its write)."""
    step_fn = make_train_step(cfg, tc)
    device = tree.leaves(params)[0].device
    batches = iter(batches)
    losses, gnorms, lrs, step_s = [], [], [], []
    tokens = 0
    t0 = time.perf_counter()
    for i in range(start, steps):
        t1 = time.perf_counter()
        batch = {k: torch.as_tensor(v).to(device)
                 for k, v in next(batches).items()}
        params, opt, metrics = step_fn(params, opt, batch, i)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        lrs.append(metrics["lr"])
        step_s.append(time.perf_counter() - t1)
        tokens += batch["tokens"].numel()
        if i % 10 == 0 or i == steps - 1:
            tok_s = tokens / (time.perf_counter() - t0)
            log(f"step {i:4d} loss={losses[-1]:.3f} "
                f"gnorm={gnorms[-1]:.2f} tok/s={tok_s:.0f}")
        if mgr is not None and i and i % ckpt_every == 0:
            mgr.save_async(i, {"params": params, "opt": opt})
    save_s = None
    if mgr is not None:
        t1 = time.perf_counter()
        mgr.save_async(steps - 1, {"params": params, "opt": opt})
        mgr.wait()
        save_s = time.perf_counter() - t1
    return {"params": params, "opt": opt, "losses": losses,
            "gnorms": gnorms, "lrs": lrs, "step_s": step_s, "save_s": save_s}


def main(argv=None):
    """Returns ``run``'s dict, with ``start`` and ``cfg``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--preset", default="cpu-small",
                    choices=["cpu-small", "full"])
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = preset_config(args.arch, args.preset)
    tc = TrainConfig(lr=1e-3, warmup=20, total_steps=args.steps)
    params, opt = init_train_state(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in tree.leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq}")

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        params, opt, start = restore(mgr, params, opt)

    pipe = DataPipeline(cfg, args.batch, args.seq, n_workers=2, prefetch=2)
    try:
        out = run(cfg, tc, params, opt, pipe, start, args.steps, mgr,
                  args.ckpt_every)
        print(f"done; checkpoints in {args.ckpt_dir}")
    finally:
        pipe.stop()
    return dict(out, start=start, cfg=cfg)


if __name__ == "__main__":
    main()
