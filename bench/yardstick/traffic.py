"""The one traffic generator.  A mix is a data file
(``traffic/<mix>.json``) of parameters that it reads:

  ``batch``               requests a batch (a closed loop: the next batch
                          starts when the previous one has ended);
  ``prompt_cycle``        {prompt length: batches of it in one cycle}: every
                          cycle holds these batches in an order drawn from
                          the seed, so that every seed runs the same work;
  ``max_new``             tokens generated a request (1: prefill only);
  ``max_seq``             cache positions (default: the longest prompt plus
                          ``max_new``);
  ``hold_cache``          keep a batch's cache until the next batch's
                          prefill has returned, as a prefill pool that hands
                          it on;
  ``check_slots``         requests of a batch whose outputs are kept for
                          the check, drawn from the seed;
  ``check_batches``       the last batches of the window whose kept requests
                          the check takes, with, beside them, the last batch
                          of the longest prompt length.

Token ids are uniform over the vocabulary, drawn on the device by a
generator seeded from ``--seed``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

import numpy as np
import torch


@dataclass
class Batch:
    index: int
    prompt_len: int
    tokens: torch.Tensor          # (batch, prompt_len) on the device
    check_slots: List[int]


def max_seq(traffic) -> int:
    longest = max(int(s) for s in traffic["prompt_cycle"])
    return traffic.get("max_seq") or longest + traffic["max_new"]


def lengths(traffic, seed: int) -> Iterator[int]:
    """Prompt lengths, batch after batch: cycles of ``prompt_cycle``, each
    in an order drawn from the seed."""
    rng = np.random.default_rng([seed % (1 << 63), 1])
    cycle = [int(s) for s, n in traffic["prompt_cycle"].items()
             for _ in range(n)]
    while True:
        yield from (cycle[i] for i in rng.permutation(len(cycle)))


def batches(traffic, vocab: int, seed: int, device) -> Iterator[Batch]:
    """The mix's batches, without end."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    rng = np.random.default_rng([seed % (1 << 63), 2])
    B = traffic["batch"]
    for i, S in enumerate(lengths(traffic, seed)):
        tokens = torch.randint(0, vocab, (B, S), generator=gen,
                               device=device)
        slots = sorted(rng.choice(B, traffic["check_slots"],
                                  replace=False).tolist())
        yield Batch(i, S, tokens, slots)


def warmup_lengths(traffic) -> List[int]:
    """Each prompt length of the mix once: the shapes set-up warms."""
    return sorted(int(s) for s in traffic["prompt_cycle"])
