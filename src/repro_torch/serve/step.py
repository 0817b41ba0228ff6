"""Serving steps: batched prefill and single-token greedy decode."""
from __future__ import annotations

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models import transformer as T


def greedy(logits):
    """(B, S, V) logits -> (B, 1) index of the first maximum of the last
    position (``jnp.argmax``'s tie rule)."""
    return torch.argmax(logits[:, -1], dim=-1, keepdim=True)


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    def prefill_step(params, batch):
        return T.prefill_forward(cfg, params, batch, max_seq=max_seq)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, tokens, pos):
        """Returns (next tokens (B, 1), cache, logits): the logits are
        returned too so that the caller can check them."""
        logits, cache = T.decode_forward(cfg, params, cache, tokens, pos)
        return greedy(logits), cache, logits
    return decode_step
