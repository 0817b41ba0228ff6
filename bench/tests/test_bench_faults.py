"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
the CPU at small sizes, with the program's steps wrapped so that each
fault a one-chip serving cell can have is planted where it is produced.
(No cell spans chips, so no exchange between chips can be left out.)"""
import pytest
import torch

import run
from yardstick import program


class Broken:
    """The program's steps with one fault planted."""

    def __init__(self, spec, fault):
        self.inner = program.Steps(spec)
        self.fault = fault
        self.vocab = spec["model"]["vocab"]

    def prefill(self, params, tokens, max_seq):
        if self.fault == "half_batch_mean":
            # half of the batch left out, its outputs the mean of the rest
            h = tokens.shape[0] // 2
            logits, cache = self.inner.prefill(params, tokens[:h], max_seq)
            logits = torch.cat([logits, logits.float().mean(0, keepdim=True)
                                .to(logits.dtype).expand_as(logits)])
            cache = {k: torch.cat([v, v.float().mean(1, keepdim=True)
                                   .to(v.dtype).expand_as(v)], 1)
                     for k, v in cache.items()}
            return logits, cache
        logits, cache = self.inner.prefill(params, tokens, max_seq)
        if self.fault == "state_unchanged":
            cache = {k: torch.zeros_like(v) for k, v in cache.items()}
        return logits, cache

    def decode(self, params, cache, tokens, pos):
        if self.fault == "state_unchanged":
            before = {k: v.clone() for k, v in cache.items()}
            tok, _, logits = self.inner.decode(params, cache, tokens, pos)
            for k, v in cache.items():
                v.copy_(before[k])
            return tok, cache, logits
        tok, cache, logits = self.inner.decode(params, cache, tokens, pos)
        return self.greedy(logits), cache, logits

    def greedy(self, logits):
        tok = self.inner.greedy(logits)
        if self.fault == "token_altered":
            tok = (tok + 1) % self.vocab
        return tok


FAULTS = ["state_unchanged", "half_batch_mean", "token_altered"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload",
                         ["phi3-prefill", "falcon-prefill", "phi3-decode"])
def test_fault_is_not_correct(cell_of, workload, fault):
    c = cell_of(workload)
    r = run.run_cell(c, 2**34 + 5, 1.0, False, "cpu",
                     steps=Broken(c.config, fault))
    assert not r["correct"], r["checked"]


@pytest.mark.parametrize("workload",
                         ["phi3-prefill", "falcon-prefill", "phi3-decode"])
def test_unbroken_wrapper_is_correct(cell_of, workload):
    c = cell_of(workload)
    r = run.run_cell(c, 2**34 + 5, 1.0, False, "cpu",
                     steps=Broken(c.config, None))
    assert r["correct"], r["checked"]
