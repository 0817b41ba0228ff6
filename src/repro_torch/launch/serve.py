"""Serving launcher: a request queue feeds fixed-size batches; each batch is
prefilled, then decoded greedily token by token against its cache (the KV
cache of the dense family, the conv tail and SSM state of the ssm family).
Whisper's prompts come with its audio stub's frame embeddings and
InternVL2's with its vision stub's patch embeddings, as the reference's
launcher makes them (``serve.step.prefill_inputs``).

``serve(cfg, ...)`` runs the loop for any ported config and returns its
counts and timings; the CLI runs an arch's smoke config, or with ``--full``
its full config (random params from a seed, made on the device):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_1b --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon_mamba_7b \
      --full --prompt-len 1024 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_small \
      --full --prompt-len 224 --max-new 32
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.step import (greedy, make_decode_step,
                                    make_prefill_step, prefill_inputs,
                                    prompt_positions)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, *, requests=8, batch=4, prompt_len=16,
          max_new=12, device="cuda", seed=0, params=None, log=print):
    """Serve ``requests`` random prompts of ``prompt_len`` tokens, ``batch``
    at a time, generating ``max_new`` tokens each.  Params come from
    ``T.init_params(cfg, seed, device)`` unless given; prompts from numpy's
    generator at ``seed``.  Returns a dict: ``requests``, ``batches``,
    per-batch ``prefill_s`` and ``decode_s`` (host clock, device synced),
    ``decode_steps`` per batch, the generated ``tokens`` per batch, and
    ``finite``: whether every logit of every step was finite."""
    device = resolve_device(device)
    if params is None:
        params = T.init_params(cfg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    queue = [rng.integers(0, cfg.vocab, (prompt_len,)) for _ in range(requests)]
    start = prompt_positions(cfg, prompt_len)
    max_seq = start + max_new
    prefill = make_prefill_step(cfg, max_seq)
    decode = make_decode_step(cfg)
    finite = torch.ones((), dtype=torch.bool, device=device)
    stats = {"requests": 0, "batches": 0, "prefill_s": [], "decode_s": [],
             "decode_steps": max_new - 1, "tokens": []}

    t0 = time.perf_counter()
    while queue:
        prompts = [queue.pop(0) for _ in range(min(batch, len(queue)))]
        tokens = torch.as_tensor(np.stack(prompts), device=device)
        _sync(device)
        t1 = time.perf_counter()
        logits, cache = prefill(params, prefill_inputs(cfg, tokens))
        finite &= torch.isfinite(logits).all()
        tok = greedy(logits)
        _sync(device)
        t2 = time.perf_counter()
        outs = [tok]
        for i in range(max_new - 1):
            tok, cache, logits = decode(params, cache, tok, start + i)
            finite &= torch.isfinite(logits).all()
            outs.append(tok)
        _sync(device)
        t3 = time.perf_counter()
        out = torch.cat(outs, 1).cpu().numpy()
        stats["requests"] += len(prompts)
        stats["batches"] += 1
        stats["prefill_s"].append(t2 - t1)
        stats["decode_s"].append(t3 - t2)
        stats["tokens"].append(out)
        log(f"[batch] finished {len(prompts)} requests "
            f"({stats['requests']}/{requests}); sample continuation: "
            f"{out[0][:8]}")
    dt = time.perf_counter() - t0
    stats["seconds"] = dt
    stats["finite"] = bool(finite)
    log(f"served {stats['requests']} requests in {dt:.2f}s "
        f"({stats['requests'] * max_new / dt:.1f} tok/s aggregate)")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3_1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="serve the arch's full config, not its smoke config")
    args = ap.parse_args(argv)
    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    serve(cfg, requests=args.requests,
          batch=args.batch, prompt_len=args.prompt_len, max_new=args.max_new,
          device=args.device)


if __name__ == "__main__":
    main()
