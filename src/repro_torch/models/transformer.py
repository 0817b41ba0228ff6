"""Decoder-only models (dense, moe and ssm families): init, prefill, decode.

Entry points, as in the JAX package:
  init_params(cfg, seed, device)                  -> params
  init_cache(cfg, batch, max_seq, device)         -> cache
  prefill_forward(cfg, params, batch, max_seq)    -> (last-token logits, cache)
  decode_forward(cfg, params, cache, tokens, pos) -> (logits, cache)

Params are a dict; ``params["layers"]`` is a list with one dict per block
where the JAX package stacks the layers along a leading axis.  A block of
the moe family has ``moe`` (``repro_torch.models.moe``) where a dense block
has ``mlp``.  The cache keeps the reference's stacked layouts, and decode
updates it in place: the dense and moe families' (L, B, Hkv, max_seq, hd)
``k`` and ``v``, or with MLA the compressed ``ckv`` (L, B, max_seq, lora)
and ``krope`` (L, B, max_seq, qk_rope); the ssm family's (Mamba1 blocks,
no attention, no MLP) ``conv`` (L, B, d_inner, d_conv-1) bf16 and ``ssm``
(L, B, d_inner, N) float32.  bf16 rounding follows the reference:
embeddings and weights are bf16, norms and attention compute in fp32 and
return bf16.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_norm, dense_init, embed_init,
                                       mlp_apply, mlp_init, norm_init,
                                       rope_tables)


def _check_family(cfg: ModelConfig):
    if cfg.family == "ssm" and cfg.ssm is not None and cfg.ssm.version == 1:
        return
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: only the dense and moe families and the ssm "
            f"family's Mamba1 are ported to repro_torch, not {cfg.family!r}"
            + (f" version {cfg.ssm.version}" if cfg.ssm else ""))


# ---------------------------------------------------------------------------
# init


def _block_init(gen, cfg: ModelConfig):
    if cfg.family == "ssm":
        return {"norm1": norm_init(cfg.d_model, gen.device),
                "ssm": ssm_mod.mamba1_init(gen, cfg)}
    p = {"norm1": norm_init(cfg.d_model, gen.device),
         "attn": attn.attn_init(gen, cfg),
         "norm2": norm_init(cfg.d_model, gen.device)}
    if cfg.family == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict:
    """Random params from ``seed``, made on ``device`` by a generator there."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = {"embed": embed_init(gen, cfg.vocab, cfg.d_model),
         "layers": [_block_init(gen, cfg) for _ in range(cfg.n_layers)],
         "final_norm": norm_init(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab)
    return p


# ---------------------------------------------------------------------------
# helpers


def _window_schedule(cfg: ModelConfig) -> List[int]:
    """Per-layer window sizes; 0 = full attention."""
    if cfg.local_global_ratio > 0:
        k = cfg.local_global_ratio + 1
        return [0 if (i + 1) % k == 0 else cfg.window
                for i in range(cfg.n_layers)]
    return [cfg.window] * cfg.n_layers


def _rope_for(cfg: ModelConfig, positions):
    if cfg.rope_theta <= 0:
        return None, None
    dim = cfg.mla.qk_rope_dim if cfg.mla is not None else cfg.resolved_head_dim
    return rope_tables(positions, dim, cfg.rope_theta)


def _embed_tokens(cfg: ModelConfig, p, tokens):
    x = p["embed"][tokens]
    if cfg.name.startswith("gemma"):
        # gemma embeds are scaled; the reference multiplies in bf16 by the
        # scale rounded to bf16
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x.to(torch.bfloat16)


def _logits(cfg: ModelConfig, p, x):
    x = apply_norm(cfg.norm, x, p["final_norm"])
    if cfg.tie_embeddings:
        return x @ p["embed"].T
    return x @ p["lm_head"]


def _ffn(cfg: ModelConfig, pl, x):
    """A block's MLP, or its MoE: returns (out, aux dict or None)."""
    if "moe" in pl:
        return moe_mod.moe_apply(pl["moe"], x, cfg)
    return mlp_apply(pl["mlp"], x, cfg.activation), None


def _backbone(cfg: ModelConfig, p, x, positions):
    """Returns (x, (load_balance, router_z) averaged over the layers, [the
    state of each layer]): (k, v) in the dense and moe families, (c_kv,
    k_rope) with MLA, dict(conv, ssm) in the ssm family.  The aux terms are
    0 without MoE layers."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        states = []
        for pl in p["layers"]:
            h, st = ssm_mod.mamba1_forward(
                pl["ssm"], apply_norm(cfg.norm, x, pl["norm1"]), cfg)
            x = x + h
            states.append(st)
        return x, (zero, zero), states
    cos, sin = _rope_for(cfg, positions)
    kvs, lb, rz = [], zero, zero
    for pl, window in zip(p["layers"], _window_schedule(cfg)):
        h_in = apply_norm(cfg.norm, x, pl["norm1"])
        if cfg.mla is not None:
            h, kv = attn.mla_forward(pl["attn"], h_in, cos, sin, cfg=cfg)
        else:
            h, kv = attn.gqa_forward(pl["attn"], h_in, cos, sin, cfg=cfg,
                                     causal=True, window=window)
        x = x + h
        h, aux = _ffn(cfg, pl, apply_norm(cfg.norm, x, pl["norm2"]))
        if aux is not None:
            lb, rz = lb + aux["load_balance"], rz + aux["router_z"]
        x = x + h
        kvs.append(kv)
    L = cfg.n_layers
    return x, (lb / L, rz / L), kvs


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    device = resolve_device(device)
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        return {"conv": torch.zeros(cfg.n_layers, batch, d_in, s.d_conv - 1,
                                    dtype=torch.bfloat16, device=device),
                "ssm": torch.zeros(cfg.n_layers, batch, d_in, s.d_state,
                                   dtype=torch.float32, device=device)}
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": torch.zeros(cfg.n_layers, batch, max_seq,
                                   m.kv_lora_rank, dtype=torch.bfloat16,
                                   device=device),
                "krope": torch.zeros(cfg.n_layers, batch, max_seq,
                                     m.qk_rope_dim, dtype=torch.bfloat16,
                                     device=device)}
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def prefill_forward(cfg: ModelConfig, params, batch,
                    max_seq: Optional[int] = None):
    """Runs the full prompt, returns (last-token logits (B, 1, V), filled
    cache).  ``batch["tokens"]``: (B, S) integer tensor on the params'
    device."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_seq = max(max_seq or S, S)
    x = _embed_tokens(cfg, params, tokens)
    x, _, states = _backbone(cfg, params, x,
                             torch.arange(S, device=x.device))
    cache = init_cache(cfg, B, max_seq, x.device)
    for li, st in enumerate(states):
        if cfg.family == "ssm":
            cache["conv"][li] = st["conv"]
            cache["ssm"][li] = st["ssm"]
        elif cfg.mla is not None:
            cache["ckv"][li, :, :S], cache["krope"][li, :, :S] = st
        else:
            cache["k"][li, :, :, :S], cache["v"][li, :, :, :S] = st
    return _logits(cfg, params, x[:, -1:]), cache


def decode_forward(cfg: ModelConfig, params, cache, tokens, pos: int):
    """One decode step.  tokens: (B, 1); pos: the position of this token.
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    _check_family(cfg)
    x = _embed_tokens(cfg, params, tokens)
    if cfg.family == "ssm":
        for li, pl in enumerate(params["layers"]):
            h, new = ssm_mod.mamba1_decode(
                pl["ssm"], apply_norm(cfg.norm, x, pl["norm1"]),
                {"conv": cache["conv"][li], "ssm": cache["ssm"][li]}, cfg)
            x = x + h
            cache["conv"][li] = new["conv"]
            cache["ssm"][li] = new["ssm"]
        return _logits(cfg, params, x), cache
    cos, sin = _rope_for(cfg, torch.full((1,), pos, device=x.device))
    for li, (pl, window) in enumerate(zip(params["layers"],
                                          _window_schedule(cfg))):
        h_in = apply_norm(cfg.norm, x, pl["norm1"])
        if cfg.mla is not None:
            h, _, _ = attn.mla_decode(pl["attn"], h_in, cache["ckv"][li],
                                      cache["krope"][li], cos, sin, cfg=cfg,
                                      pos=pos)
        else:
            h, _, _ = attn.gqa_decode(pl["attn"], h_in, cache["k"][li],
                                      cache["v"][li], cos, sin, cfg=cfg,
                                      pos=pos, window=window)
        x = x + h
        x = x + _ffn(cfg, pl, apply_norm(cfg.norm, x, pl["norm2"]))[0]
    return _logits(cfg, params, x), cache
