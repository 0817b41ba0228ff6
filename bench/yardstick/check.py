"""The comparison that decides ``correct``.

Once the window has closed, the kept requests (``loop.Kept``: a sample of
the finished requests drawn from the seed, with the longest prompt in it)
are run through the configuration's plain float32 reference
(``reference/<family>.py``) over their prompts and served tokens, one at
a time, and three numbers are read, each the worst over the sample:

  ``gap``     the widest gap by which a served token's reference logit
              lies below the reference's best at that position (greedy
              serving picks the best; logit units);
  ``logits``  the largest difference between the program's logits of a
              served token and the reference's, over the vocabulary, in
              units of the reference logits' standard deviation there;
  ``cache``   the largest relative L2 difference, over the layers and the
              cache's leaves, between the rows of the cache the program
              handed on (its keys and values, or its conv tail and scan
              state) and the reference's, worked out again.

Each is held to its limit in ``limits/<workload>.json``.  The control
(``control_numbers``) reads the same numbers of the reference computed in
float8 against the float32 one; it is run by ``tools/calibrate.py``, not
by the benchmark's runs.
"""
from __future__ import annotations

import importlib
from typing import Dict, Iterator, List, Tuple

import torch

NUMBERS = ("gap", "logits", "cache")


def family(spec):
    return importlib.import_module(f"reference.{spec['reference']}")


def requests(kept) -> Iterator[Tuple]:
    """(prompt (S,), served (n,), program logits (n, V), program cache
    {key: (L, ...)}) of each kept request."""
    for k in kept:
        for j, slot in enumerate(k.slots):
            logits = torch.stack([l[slot, -1] for l in k.logits])
            yield (k.prompts[j], k.served[j], logits,
                   {key: v[:, j] for key, v in k.cache.items()})


def _sequence(prompt, served):
    """The tokens the reference runs: the prompt, then every served token
    that was fed back; and the positions whose logits picked the served
    tokens."""
    S, n = prompt.shape[0], len(served)
    fed = torch.as_tensor(served[:-1], device=prompt.device,
                          dtype=prompt.dtype)
    return torch.cat([prompt, fed]), torch.arange(S - 1, S - 1 + n,
                                                  device=prompt.device)


def _rel(a, ref):
    ref = ref.float()
    return float((a.float() - ref).norm() / ref.norm().clamp(min=1e-30))


def _cache_rows(prog, li, ref):
    """The program's layer ``li`` of a cache leaf, cut to the positions
    the reference has (a key or value cache is longer than the sequence
    it holds)."""
    p = prog[li]
    if p.dim() == 3 and ref.dim() == 3 and p.shape[1] != ref.shape[1]:
        p = p[:, :ref.shape[1]]
    return p


def _gap(ref, tokens):
    return float((ref.max(-1).values - ref.gather(
        -1, tokens[:, None])[:, 0]).max())


def _logit_err(prog, ref):
    return float(((prog.float() - ref).abs().amax(-1)
                  / ref.std(-1).clamp(min=1e-30)).max())


def _worst(out, seen):
    """NaN for every number where no request was read: no evidence is
    not a pass."""
    return out if seen else dict.fromkeys(NUMBERS, float("nan"))


def program_numbers(spec, params, kept, layers=None) -> Dict[str, float]:
    """The three numbers of the program's kept outputs.  ``layers``, a
    list, receives each request's cache differences layer by layer."""
    ref_mod = family(spec)
    out = dict.fromkeys(NUMBERS, 0.0)
    seen = 0
    for prompt, served, logits, cache in requests(kept):
        seen += 1
        seq, positions = _sequence(prompt, served)
        errs: List[float] = []

        def hook(li, state):
            errs.extend(_rel(_cache_rows(cache[key], li, ref), ref)
                        for key, ref in state.items())
        ref = ref_mod.forward(spec, params, seq, positions, "fp32", hook)
        tokens = torch.as_tensor(served, device=ref.device).long()
        out["gap"] = max(out["gap"], _gap(ref, tokens))
        out["logits"] = max(out["logits"], _logit_err(logits, ref))
        out["cache"] = max(out["cache"], max(errs))
        if layers is not None:
            layers.append(errs)
        del ref, logits, cache
    return _worst(out, seen)


def control_numbers(spec, params, kept) -> Dict[str, float]:
    """The same numbers of the control: the reference computed in float8
    in the program's place, against the float32 reference, at the same
    prompts, served tokens and positions as the program's.  ``gap`` is
    read of the token that the float8 reference puts first there."""
    ref_mod = family(spec)
    out = dict.fromkeys(NUMBERS, 0.0)
    seen = 0
    for prompt, served, _, _ in requests(kept):
        seen += 1
        seq, positions = _sequence(prompt, served)
        states: Dict[Tuple[int, str], torch.Tensor] = {}

        def keep(li, state):
            for key, v in state.items():
                states[li, key] = v.clone()
        errs: List[float] = []

        def compare(li, state):
            errs.extend(_rel(v, states[li, key]) for key, v in state.items())
        ref = ref_mod.forward(spec, params, seq, positions, "fp32", keep)
        low = ref_mod.forward(spec, params, seq, positions, "fp8", compare)
        out["gap"] = max(out["gap"], _gap(ref, low.argmax(-1)))
        out["logits"] = max(out["logits"], _logit_err(low, ref))
        out["cache"] = max(out["cache"], max(errs))
        del ref, low, states
    return _worst(out, seen)


def verdict(numbers: Dict[str, float], limits: Dict) -> Tuple[bool, Dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    shown = {k: {"value": numbers[k], "limit": limits[k]["limit"]}
             for k in NUMBERS}
    ok = all(v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
