"""Batched serving — measured and modeled in one script.

Default mode runs the real path: prefill a batch of prompts, then greedy
decode with a shared KV cache, on the card unless ``--device cpu``.
``--simulate`` replays a synthetic request trace against the same batching
policy through the serving simulator (``repro_torch.sim.serving``) instead.
Both modes share the ``repro_torch.serve.policy`` dataclasses: the measured
batch is sized by ``policy.max_batch``; the simulator replays the full
admission / eviction semantics.  The simulated mode prices on one H100 at
its bf16 peak (``repro_torch.apps.serving.default_config``).

  PYTHONPATH=src python -m repro_torch.launch.serve_batch --arch gemma3_1b \\
      --tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve_batch --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_batch --simulate \\
      --policy continuous --rate 50 --requests 64
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.launch.serve import _sync
from repro_torch.models import transformer as T
from repro_torch.serve import get_policy
from repro_torch.serve.policy import BatchingPolicy
from repro_torch.serve.step import (greedy, make_decode_step,
                                    make_prefill_step, prefill_inputs,
                                    prompt_positions)


def run_measured(cfg: ModelConfig, policy: BatchingPolicy, *,
                 prompt_len: int = 32, tokens: int = 16, device="cuda",
                 seed: int = 0, params=None, log=print):
    """Prefill one batch of ``policy.max_batch`` random prompts of
    ``prompt_len`` tokens, then greedy-decode ``tokens - 1`` steps.  Params
    come from ``T.init_params(cfg, seed, device)`` unless given; prompts
    from numpy's generator at ``seed``.  Returns a dict: ``batch``,
    ``prefill_s`` and ``decode_s`` (host clock, device synced), the
    generated ``tokens`` (batch, tokens), the prefill's last-position
    ``logits`` (on ``device``) and ``finite``: whether every logit of every
    step was finite."""
    device = resolve_device(device)
    if params is None:
        params = T.init_params(cfg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    batch_n = policy.max_batch
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           (batch_n, prompt_len)),
                              device=device)
    start = prompt_positions(cfg, prompt_len)
    prefill = make_prefill_step(cfg, start + tokens)
    decode = make_decode_step(cfg)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prefill_inputs(cfg, prompts))
    finite = torch.isfinite(logits).all()
    last = logits[:, -1]
    tok = greedy(logits)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    log(f"prefill {batch_n}x{prompt_len} in {prefill_s:.2f}s")

    out = [tok]
    t0 = time.perf_counter()
    for i in range(tokens - 1):
        tok, cache, logits = decode(params, cache, tok, start + i)
        finite &= torch.isfinite(logits).all()
        out.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    gen = torch.cat(out, 1).cpu().numpy()
    log(f"decoded {tokens - 1} steps in {dt:.2f}s "
        f"({batch_n * (tokens - 1) / max(dt, 1e-9):.1f} tok/s)")
    log(f"generated ids:\n {gen}")
    return {"batch": batch_n, "prefill_s": prefill_s, "decode_s": dt,
            "tokens": gen, "logits": last, "finite": bool(finite)}


def run_simulated(arch: str, policy: str, *, rate: float, requests: int,
                  batch: int, seed: int = 0, full: bool = False,
                  config=None, log=print):
    """Price ``arch`` serving a ``requests``-long Poisson trace at ``rate``
    requests/s under ``policy`` with ``apps.serving.serve_trace`` (on
    ``config``, default one H100 at its bf16 peak) and log the summary:
    wall and engine-busy time, steps, throughput, occupancy, TTFT/TPOT,
    the breakdown and the wall-clock step timeline.  Returns the
    ``ServingResult``."""
    from repro_torch.apps.serving import serve_trace

    # model the same reduced config the measured mode runs (--full for the
    # registry's full-size config), so the two modes stay comparable
    res = serve_trace(arch, policy, rate_rps=rate, n_requests=requests,
                      max_batch=batch, seed=seed, smoke=not full,
                      config=config)
    s = res.stats()
    log(f"simulated {requests} requests @ {rate:g} req/s on "
        f"{arch}{'' if full else ' (smoke config)'} "
        f"({policy} batching, max_batch={batch}):")
    log(f"  wall {s['makespan_s']:.3f}s "
        f"(engine busy {res.engine.makespan:.3f}s), "
        f"{s['n_steps']:.0f} scheduler steps")
    log(f"  throughput {s['throughput_tok_s']:.0f} tok/s "
        f"({s['throughput_req_s']:.1f} req/s), "
        f"occupancy {s['occupancy']:.2f}")
    log(f"  TTFT p50/p99 {s['ttft_p50']*1e3:.4g}/{s['ttft_p99']*1e3:.4g} "
        f"ms, TPOT p50 {s['tpot_p50']*1e3:.4g} ms")
    b = res.engine.breakdown.fractions()
    log(f"  breakdown: accel {b['accelerator']*100:.0f}% / transfer "
        f"{b['transfer']*100:.0f}% / host {b['host']*100:.0f}%")
    log(res.wall_timeline().ascii(width=64))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3_1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--policy", default="static",
                    choices=["static", "dynamic", "continuous"])
    ap.add_argument("--simulate", action="store_true",
                    help="replay a synthetic trace through the serving "
                         "simulator instead of running the model")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="(simulate) arrival rate, requests/s")
    ap.add_argument("--requests", type=int, default=64,
                    help="(simulate) trace length")
    ap.add_argument("--full", action="store_true",
                    help="(simulate) model the full-size registry config "
                         "instead of the smoke config the measured mode "
                         "runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="(measured) where the model runs")
    args = ap.parse_args(argv)
    if args.simulate:
        run_simulated(args.arch, args.policy, rate=args.rate,
                      requests=args.requests, batch=args.batch,
                      seed=args.seed, full=args.full)
    else:
        run_measured(get_smoke_config(args.arch),
                     get_policy(args.policy, max_batch=args.batch),
                     prompt_len=args.prompt_len, tokens=args.tokens,
                     device=args.device)


if __name__ == "__main__":
    main()
