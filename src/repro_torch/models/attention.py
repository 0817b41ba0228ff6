"""Attention: GQA/MQA with causal and sliding-window masks.

Prefill attention goes through ``repro_torch.kernels.ops.flash_attention``:
the CUDA flash kernel on the card, its plain version on the CPU.  Decode
attention (one query against the cache) is plain PyTorch, as the JAX package
computes it outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


def attn_init(gen, cfg: ModelConfig, *, dtype=torch.bfloat16):
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    return {
        "q": dense_init(gen, d, H * hd, dtype=dtype),
        "k": dense_init(gen, d, Hkv * hd, dtype=dtype),
        "v": dense_init(gen, d, Hkv * hd, dtype=dtype),
        "o": dense_init(gen, H * hd, d, dtype=dtype),
    }


def _rope_heads(x, cos, sin):
    """x: (B, H, S, D); cos/sin: (S, D/2), or (1, D/2) for decode."""
    return apply_rope(x, cos[None, None], sin[None, None])


def decode_attention(q, k_cache, v_cache, *, pos, window=0):
    """Single-token decode.  q: (B, H, 1, D); caches: (B, Hkv, S, D).

    Keys at index > ``pos`` are masked, and for ``window > 0`` so are keys
    ``window`` or more behind ``pos``.  Query heads are grouped onto the
    native ``Hkv`` KV heads."""
    B, H, _, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    qg = q[:, :, 0].float().reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float()) * (D ** -0.5)
    k_pos = torch.arange(S, device=q.device)
    mask = k_pos <= pos
    if window > 0:
        mask &= (pos - k_pos) < window
    s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", w, v_cache.float())
    return out.reshape(B, H, 1, D).to(q.dtype)


def gqa_forward(p, x, cos, sin, *, cfg: ModelConfig, causal=True, window=0):
    """Full-sequence (prefill) attention.  Returns (out, (k, v)) with k, v
    of shape (B, Hkv, S, hd) after RoPE."""
    B, S, _ = x.shape
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    q = (x @ p["q"]).reshape(B, S, H, hd).transpose(1, 2)
    k = (x @ p["k"]).reshape(B, S, Hkv, hd).transpose(1, 2)
    v = (x @ p["v"]).reshape(B, S, Hkv, hd).transpose(1, 2)
    if cos is not None:
        q = _rope_heads(q, cos, sin)
        k = _rope_heads(k, cos, sin)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return out @ p["o"], (k, v)


def gqa_decode(p, x, cache_k, cache_v, cos, sin, *, cfg: ModelConfig, pos,
               window=0):
    """One-token decode.  x: (B, 1, d); cache_[kv]: (B, Hkv, S, hd).

    Writes this token's k and v into the caches IN PLACE at ``pos`` (the JAX
    package returns updated copies) and returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    q = (x @ p["q"]).reshape(B, 1, H, hd).transpose(1, 2)
    k_new = (x @ p["k"]).reshape(B, 1, Hkv, hd).transpose(1, 2)
    v_new = (x @ p["v"]).reshape(B, 1, Hkv, hd).transpose(1, 2)
    if cos is not None:
        q = _rope_heads(q, cos, sin)
        k_new = _rope_heads(k_new, cos, sin)
    cache_k[:, :, pos:pos + 1] = k_new.to(cache_k.dtype)
    cache_v[:, :, pos:pos + 1] = v_new.to(cache_v.dtype)
    out = decode_attention(q, cache_k, cache_v, pos=pos, window=window)
    out = out.transpose(1, 2).reshape(B, 1, H * hd)
    return out @ p["o"], cache_k, cache_v
