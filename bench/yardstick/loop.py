"""The benchmark's serving loop: a copy of the batch loop of
``repro_torch.launch.serve.serve`` with one change, as a streaming server
has it: each step's tokens are copied to the host, and that copy ends the
step's time.

A unit is one call of a step: a batch's prefill (its prompts made on the
device, prefilled, the first tokens picked greedily and copied to the
host) or one decode step (the step called at the next position, its tokens
copied).  The window runs units from its start until ``seconds`` have
passed; it ends at the end of the last unit that completed before then,
and the unit in flight at that moment is finished and discarded, so that
no rate counts part of a unit.

For the check, the loop keeps the outputs of the mix's ``check_slots``
requests of each completed batch: their prompts, served tokens, the
logits of each served token and a copy of their rows of the cache the
batch ended with, cut to the positions the requests hold, for the last
``check_batches`` batches and the last batch of the longest prompt.
Where no batch completed in the window, the batch in flight is run to its
end after the close, untimed, and kept.  The window's peak of allocated
device memory is read unit by unit, less the kept copies alive at the
time: they are the measurement's, which no deployment holds.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from yardstick import traffic as mix
from yardstick.trace import NoTrace

WARM_DECODE_STEPS = 3


@dataclass
class Unit:
    kind: str        # "prefill" | "decode"
    batch: int       # the batch's index in the window
    size: int        # requests in the call
    first: int       # the position of the call's first token
    n: int           # tokens a request the call runs
    start: float     # host clock: the unit began (a prefill: before its
                     # prompts were made)
    call: float      # the step was called
    ret: float       # the step returned, before the token copy
    end: float       # the tokens were on the host
    traced: bool = False


@dataclass
class Kept:
    """The outputs of one completed batch's checked requests."""
    prompt_len: int
    slots: List[int]
    prompts: torch.Tensor              # (slots, prompt_len)
    served: np.ndarray                 # (slots, max_new)
    logits: List[torch.Tensor]         # a served token's (B, 1, V) each
    cache: Dict[str, torch.Tensor]     # {key: (L, slots, ...)}


@dataclass
class Window:
    begin: float
    end: float
    units: List[Unit] = field(default_factory=list)
    kept: List[Kept] = field(default_factory=list)
    requests: int = 0       # requests whose batch began in the window
    failed: int = 0         # of those, requests served a token outside
                            # the vocabulary
    peak: int = 0           # device bytes allocated at most in a unit,
                            # less the kept copies
    kept_bytes: int = 0     # the kept copies at most


def _now():
    return time.perf_counter()


def _snapshot(cache, slots, device, max_seq, positions):
    """The rows of ``slots`` (a cache leaf's dimension 1) of each leaf, its
    positions (a dimension past 1 of ``max_seq`` entries) cut to the first
    ``positions``."""
    idx = torch.tensor(slots, device=device)
    out = {}
    for k, v in cache.items():
        cut = tuple(slice(0, positions) if d > 1 and n == max_seq
                    else slice(None) for d, n in enumerate(v.shape))
        out[k] = v[cut].index_select(1, idx)
    return out


def _bytes(kept):
    return sum(v.numel() * v.element_size()
               for k in kept for v in k.cache.values())


def warm(steps, params, spec, traffic, device, log=None):
    """Runs the mix's shapes once each, as the window will: a prefill for
    each prompt length (the longest twice, the second beside the first's
    held cache where the mix holds caches), a few decode steps after it,
    and the check's copy of its cache rows."""
    B, max_new = traffic["batch"], traffic["max_new"]
    S_max = mix.max_seq(traffic)
    gen = torch.Generator(device=device).manual_seed(0)
    held = None
    lengths = mix.warmup_lengths(traffic)
    for S in lengths + lengths[-1:]:
        t = _now()
        tokens = torch.randint(0, spec["model"]["vocab"], (B, S),
                               generator=gen, device=device)
        logits, cache = steps.prefill(params, tokens, S_max)
        tok = steps.greedy(logits)
        tok.cpu()
        for i in range(min(WARM_DECODE_STEPS, max_new - 1)):
            tok, cache, _ = steps.decode(params, cache, tok, S + i)
            tok.cpu()
        _snapshot(cache, list(range(traffic["check_slots"])), device, S_max,
                  S + max_new - 1)
        held = cache if traffic.get("hold_cache") else None
        del cache
        if log is not None:
            log(f"warm-up at prompt {S}: {_now() - t:.3f} s")
    del held


def serve(steps, params, spec, traffic, seed, seconds, device,
          tracer=NoTrace()) -> Window:
    """Runs the window; returns its units and kept outputs."""
    V = spec["model"]["vocab"]
    B, max_new = traffic["batch"], traffic["max_new"]
    S_max = mix.max_seq(traffic)
    longest = max(mix.warmup_lengths(traffic))
    ring = deque(maxlen=traffic["check_batches"])
    last_longest: Optional[Kept] = None
    batches = mix.batches(traffic, V, seed, device)
    w = Window(begin=_now(), end=0.0)
    w.end = w.begin
    deadline = w.begin + seconds
    n_unit = 0
    kept_now = 0
    cuda = torch.device(device).type == "cuda"

    def unit(kind, index, first, n, step, make=None):
        """Runs one unit: ``make()`` (a prefill's prompts), then
        ``step(made)`` -> (tokens, ...), then the token copy.  Returns
        (the step's outputs, the tokens on the host, whether the unit ended
        inside the window)."""
        nonlocal n_unit
        tracer.before(n_unit)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        start = _now()
        made = None
        if make is not None:
            with tracer.span("make_batch"):
                made = make()
        call = _now()
        with tracer.span(kind if kind == "prefill" else "decode_step"):
            out = step(made)
        ret = _now()
        with tracer.span("token_copy"):
            host = out[0].cpu().numpy()
        end = _now()
        if cuda:
            w.peak = max(w.peak,
                         torch.cuda.max_memory_allocated(device) - kept_now)
        traced = tracer.active
        tracer.after(n_unit)
        n_unit += 1
        inside = end <= deadline
        if inside:
            w.units.append(Unit(kind, index, B, first, n, start, call, ret,
                                end, traced))
            w.end = end
            w.failed += int(((host < 0) | (host >= V)).any(axis=1).sum())
        return out, host, inside

    held = None
    for index in range(1 << 62):
        box = {}

        def make():
            box["batch"] = next(batches)
            return box["batch"]

        def prefill(batch):
            logits, cache = steps.prefill(params, batch.tokens, S_max)
            return steps.greedy(logits), cache, logits
        (tok, cache, logits), host, inside = unit("prefill", index, 0, None,
                                                  prefill, make)
        batch = box["batch"]
        S = batch.prompt_len
        closed = not inside
        if closed and (ring or last_longest is not None):
            break
        if not closed:
            w.units[-1].n = S
            w.requests += B
        served, step_logits = [host], [logits]
        for i in range(0 if closed else max_new - 1):
            (tok, cache, logits), host, inside = unit(
                "decode", index, S + i, 1,
                lambda _: steps.decode(params, cache, tok, S + i))
            served.append(host)
            step_logits.append(logits)
            if not inside:
                closed = True
                break
        if closed and (ring or last_longest is not None):
            break
        # where nothing completed in the window, this batch is finished
        # after the close, untimed, for the check
        for i in range(len(served) - 1, max_new - 1):
            tok, cache, logits = steps.decode(params, cache, tok, S + i)
            served.append(tok.cpu().numpy())
            step_logits.append(logits)
        with tracer.span("check_keep"):
            kept = Kept(S, batch.check_slots,
                        batch.tokens[batch.check_slots],
                        np.concatenate(served, 1)[batch.check_slots],
                        step_logits,
                        _snapshot(cache, batch.check_slots, device, S_max,
                                  S + max_new - 1))
        ring.append(kept)
        if S == longest:
            last_longest = kept
        kept_now = _bytes({id(k): k for k in [*ring, last_longest]
                           if k is not None}.values())
        w.kept_bytes = max(w.kept_bytes, kept_now)
        held = cache if traffic.get("hold_cache") else None
        del cache, logits, step_logits
        if closed:
            break
    del held
    w.kept = list(ring) + ([last_longest] if last_longest is not None
                           and all(k is not last_longest for k in ring)
                           else [])
    return w


def units_as_dicts(w: Window) -> List[Dict]:
    return [asdict(u) for u in w.units]
