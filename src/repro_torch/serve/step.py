"""Serving steps: batched prefill and single-token greedy decode."""
from __future__ import annotations

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models import transformer as T


def greedy(logits):
    """(B, S, V) logits -> (B, 1) index of the first maximum of the last
    position (``jnp.argmax``'s tie rule)."""
    return torch.argmax(logits[:, -1], dim=-1, keepdim=True)


def prefill_inputs(cfg: ModelConfig, tokens):
    """The batch dict of prompts ``tokens`` (B, S), with the stub
    frontends' embeddings beside them as the reference's launcher makes
    them, float32 0.1 everywhere: whisper's ``frames`` (B, n_ctx, d),
    InternVL2's ``patches`` (B, n_patches, d)."""
    batch = {"tokens": tokens}
    B = tokens.shape[0]
    if cfg.family == "encdec":
        batch["frames"] = torch.full((B, cfg.encoder.n_ctx, cfg.d_model),
                                     0.1, device=tokens.device)
    if cfg.family == "vlm":
        batch["patches"] = torch.full((B, cfg.n_patches, cfg.d_model), 0.1,
                                      device=tokens.device)
    return batch


def prompt_positions(cfg: ModelConfig, prompt_len: int) -> int:
    """The cache positions that a prompt of ``prompt_len`` tokens fills,
    where decode starts: the vlm family's patches come first."""
    return prompt_len + (cfg.n_patches if cfg.family == "vlm" else 0)


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
