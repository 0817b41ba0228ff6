"""The model zoo's transformers (dense, moe, ssm, hybrid, encdec and vlm
families): init, prefill, decode.

Entry points, as in the JAX package:
  init_params(cfg, seed, device)                  -> params
  param_axes(cfg)                                 -> logical-axes tree
  train_forward(cfg, params, batch)               -> (logits, aux)
  loss_fn(cfg, params, batch)                     -> (loss, metrics)
  init_cache(cfg, batch, max_seq, device)         -> cache
  cache_axes(cfg, batch, max_seq)                 -> logical-axes tree
  prefill_forward(cfg, params, batch, max_seq)    -> (last-token logits, cache)
  (``batch``: ``tokens``, and whisper's ``frames`` or InternVL2's
  ``patches``, the stub frontends' precomputed embeddings)
  decode_forward(cfg, params, cache, tokens, pos) -> (logits, cache)

Params are a dict; ``params["layers"]`` is a list with one dict per block
where the JAX package stacks the layers along a leading axis.  A block of
the moe family has ``moe`` (``repro_torch.models.moe``) where a dense block
has ``mlp``; a block of the ssm family is one Mamba mixer (Mamba1, or
Mamba2 at ``ssm.version`` 2; no attention, no MLP).  The hybrid family
(zamba2) runs superblocks of ``hybrid_attn_every`` Mamba2 blocks, each
followed by the one shared attention + MLP block ``params["shared_attn"]``
(one set of params, applied n_layers / hybrid_attn_every times, with the
rope tables of the whole prompt).  The encdec family (whisper) adds
``params["encoder"]`` (``layers``: dense blocks run without a causal mask,
over frame embeddings plus a sinusoid table; ``final_norm``), a learned
position table ``params["pos"]`` added to the decoder's token embeddings,
and a cross-attention (``norm_x``, ``xattn``) in each decoder block after
its self-attention.  The vlm family (InternVL2) is the dense decoder over
the bf16 patch embeddings followed by the tokens: the patches take cache
positions [0, n_patches).  The cache keeps the reference's stacked
layouts, and decode updates it in place: the dense and moe families'
(L, B, Hkv, max_seq, hd) ``k`` and ``v``, or with MLA the compressed
``ckv`` (L, B, max_seq, lora) and ``krope`` (L, B, max_seq, qk_rope); the
ssm family's ``conv`` (L, B, d_inner, d_conv-1) bf16 and ``ssm`` (L, B,
d_inner, N) float32 with Mamba1, or with Mamba2 ``conv`` (L, B, d_inner +
2N, d_conv-1) and ``ssm`` (L, B, H, P, N); the hybrid family's Mamba2
``conv`` and ``ssm`` and the shared block's ``k`` and ``v`` (L / k, B,
Hkv, max_seq, hd), one a superblock; the encdec family's ``k`` and ``v``
and the encoder's keys and values for cross-attention ``xk`` and ``xv``
(L, B, Hkv, n_ctx, hd).  bf16 rounding follows the
reference: embeddings and weights are bf16, norms and attention compute in
fp32 and return bf16.

When autograd records a forward (training), each block runs under
activation checkpointing (``torch.utils.checkpoint``, non-reentrant), where
the reference wraps its scan bodies in ``jax.checkpoint``: the backward
recomputes a block from its input.  ``PerfFlags`` (``repro_torch.dist``)
select the reference's ablations: ``windowed_attention`` gives a
local:global arch's local layers a static window in prefill, training and
decode; ``ssm_impl`` picks Mamba1's scan; ``moe_dispatch`` the MoE's
dispatch; ``attn_remat_chunk`` acts in ``attention.chunked_attention``.

In the train step over a ``model`` axis (``train.step``) the same
functions compute on this rank's shards of the leaves the rules split
(``dist.tp``): the embedding and the logits are vocab-parallel
(``_token_rows``, ``_logits``, and ``loss_fn``'s log-sum-exp over the
shards), and under ``PerfFlags.seq_sharded_residual`` the blocks'
residual stream is this rank's slice of the sequence (``_seq_sharded``).
An activation checkpoint's recompute runs under the forward's
distribution context (``_run``).

In the serving steps on the rules' shards (``serve.step``) the same
prefill and decode run on this rank's shards, with ``layout`` ({cache key:
(logical axes, spec)}): the cache is the rank's shard of each leaf
(``local_cache``), the prefill cuts each layer's state to it
(``_put_state``), and decode passes each attention the cache's slice of
the positions (``_seq_split``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tree
from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.spans import span, spanned
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import tp
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_norm, dense_init, embed_init,
                                       mlp_apply, mlp_init, norm_init,
                                       rope_tables, sinusoid_positions)


def _check_family(cfg: ModelConfig):
    version = cfg.ssm.version if cfg.ssm is not None else None
    if cfg.family in ("dense", "moe", "encdec", "vlm") \
            or (cfg.family == "ssm" and version in (1, 2)):
        return
    if cfg.family == "hybrid" and version == 2:
        k = cfg.hybrid_attn_every
        if k <= 0 or cfg.n_layers % k:
            raise ValueError(f"{cfg.name}: hybrid_attn_every {k} must divide "
                             f"n_layers {cfg.n_layers}")
        return
    raise NotImplementedError(
        f"{cfg.name}: the dense, moe, ssm, hybrid (Mamba2), encdec and vlm "
        f"families are ported to repro_torch, not {cfg.family!r}"
        + (f" version {version}" if cfg.ssm else ""))


def _mamba(cfg: ModelConfig):
    """(init, forward, decode) of the Mamba version of ``cfg``'s blocks."""
    if cfg.ssm.version == 1:
        return ssm_mod.mamba1_init, ssm_mod.mamba1_forward, \
            ssm_mod.mamba1_decode
    return ssm_mod.mamba2_init, ssm_mod.mamba2_forward, ssm_mod.mamba2_decode


# ---------------------------------------------------------------------------
# init


def _block_init(gen, cfg: ModelConfig, shared=False):
    """One block of ``cfg``'s stack; with ``shared``, an attention + MLP
    block outside it (the hybrid family's shared block, the encdec
    family's encoder blocks)."""
    if cfg.family in ("ssm", "hybrid") and not shared:
        return {"norm1": norm_init(cfg.d_model, gen.device),
                "ssm": _mamba(cfg)[0](gen, cfg)}
    p = {"norm1": norm_init(cfg.d_model, gen.device),
         "attn": attn.attn_init(gen, cfg),
         "norm2": norm_init(cfg.d_model, gen.device)}
    if cfg.family == "encdec" and not shared:
        p["norm_x"] = norm_init(cfg.d_model, gen.device)
        p["xattn"] = attn.attn_init(gen, cfg)
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
    if cfg.family == "encdec":
        p["encoder"] = {"layers": [_block_init(gen, cfg, shared=True)
                                   for _ in range(cfg.encoder.n_layers)],
                        "final_norm": norm_init(cfg.d_model, device)}
        p["pos"] = (torch.randn(min(cfg.max_seq, 32_768), cfg.d_model,
                                generator=gen, device=device) * 0.01
                    ).to(torch.bfloat16)
    if cfg.family == "hybrid":
        p["shared_attn"] = _block_init(gen, cfg, shared=True)
    return p


def _mlp_axes(gated):
    p = {"up": ("d_model", "d_ff"), "down": ("d_ff", "d_model")}
    if gated:
        p["gate"] = ("d_model", "d_ff")
    return p


def _block_axes(cfg: ModelConfig, shared=False):
    """``_block_init``'s structure with the reference's logical axes at each
    leaf (its stacked leaves' without the leading ``"layers"``)."""
    if cfg.family in ("ssm", "hybrid") and not shared:
        ssm = {"in_proj": ("d_model", "d_inner"), "conv_w": ("d_inner", None),
               "conv_b": ("d_inner",)}
        if cfg.ssm.version == 1:
            ssm.update(x_proj=("d_inner", None), dt_proj=(None, "d_inner"),
                       dt_bias=("d_inner",), A_log=("d_inner", None),
                       D=("d_inner",))
        else:
            ssm.update(A_log=(None,), dt_bias=(None,), D=(None,),
                       norm=(None,))
        ssm["out_proj"] = ("d_inner", "d_model")
        return {"norm1": (None,), "ssm": ssm}
    if cfg.mla is not None:
        att = {"q": ("d_model", "heads_x_dim"), "kv_a": ("d_model", None),
               "kv_norm": (None,), "kv_b": (None, "heads_x_dim"),
               "o": ("heads_x_dim", "d_model")}
    else:
        att = {"q": ("d_model", "heads_x_dim"),
               "k": ("d_model", "kv_heads_x_dim"),
               "v": ("d_model", "kv_heads_x_dim"),
               "o": ("heads_x_dim", "d_model")}
    p = {"norm1": (None,), "attn": att, "norm2": (None,)}
    if cfg.family == "encdec" and not shared:
        p["norm_x"] = (None,)
        p["xattn"] = dict(att)
    if cfg.family == "moe":
        p["moe"] = {"router": ("d_model", None),
                    "gate": ("experts", "d_model", None),
                    "up": ("experts", "d_model", None),
                    "down": ("experts", None, "d_model")}
        if cfg.moe.n_shared:
            p["moe"]["shared"] = _mlp_axes(True)
    else:
        p["mlp"] = _mlp_axes(cfg.activation in ("swiglu", "geglu"))
    return p


def param_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of ``init_params(cfg)``'s leaves, in its structure:
    the reference's axes tree leaf for leaf, a block's leaves without the
    stacked ``"layers"`` axis the port's per-block tensors lack.  What
    ``dist.sharding.Rules.tree_shardings`` takes."""
    _check_family(cfg)
    p = {"embed": ("vocab", "d_model"),
         "layers": [_block_axes(cfg) for _ in range(cfg.n_layers)],
         "final_norm": (None,)}
    if not cfg.tie_embeddings:
        p["lm_head"] = ("d_model", "vocab")
    if cfg.family == "encdec":
        p["encoder"] = {"layers": [_block_axes(cfg, shared=True)
                                   for _ in range(cfg.encoder.n_layers)],
                        "final_norm": (None,)}
        p["pos"] = (None, "d_model")
    if cfg.family == "hybrid":
        p["shared_attn"] = _block_axes(cfg, shared=True)
    return p


# ---------------------------------------------------------------------------
# helpers


def _recorded(p, x) -> bool:
    """Whether autograd records a forward of params ``p`` on input ``x``:
    then its blocks run under activation checkpointing."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in tree.leaves(p)))


def _run(remat, fn, *args):
    """``fn(*args)``, checkpointed when ``remat``: its activations are
    recomputed in the backward rather than kept, under the distribution
    context of the forward (``dist.context.snapshot``: bound axes, global
    batch, sequence sharding), which the backward may run outside of."""
    if remat:
        state = dist_ctx.snapshot()
        return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: (
            contextlib.nullcontext(), dist_ctx.restored(state)))
    return fn(*args)


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
    return rope_tables(positions, dim, cfg.rope_theta, cfg.rope_scaling)


class _Gather(torch.autograd.Function):
    """``embed[tokens]``, whose gradient sums each token's rows in float32
    and rounds once to the table's dtype.  Autograd's own backward of the
    indexing (``index_put_`` with accumulate) reads and writes the bf16
    table once for each occurrence of a token, so a frequent token's row
    is rounded hundreds of times: with a zipfian batch of 1,024 tokens on
    an H100 its bf16 gradient moved by 3.7% relative L2 between the whole
    batch and two halves of it summed.  ``F.embedding``'s CPU backward
    rounds in the same way, so the tests on the CPU need this one.  With
    ``valid`` (a bool mask of the tokens' shape) the rows of the tokens
    outside it are zeros and take no gradient."""

    @staticmethod
    def forward(ctx, embed, tokens, valid=None):
        ctx.save_for_backward(tokens, valid)
        ctx.table = (embed.shape, embed.dtype)
        rows = embed[tokens]
        if valid is not None:
            rows = torch.where(valid[..., None], rows, 0)
        return rows

    @staticmethod
    def backward(ctx, grad):
        (tokens, valid), (shape, dtype) = ctx.saved_tensors, ctx.table
        g = grad.reshape(-1, shape[1]).float()
        if valid is not None:
            g = torch.where(valid.reshape(-1, 1), g, 0)
        out = torch.zeros(shape, dtype=torch.float32, device=grad.device)
        out.index_put_((tokens.reshape(-1),), g, accumulate=True)
        return out.to(dtype), None, None


def _token_rows(embed, tokens):
    """``embed[tokens]``.  Where ``embed`` is this rank's shard of the
    vocab (the train step over ``model``), the rows of the tokens in its
    range, the others masked to zero rows, summed over ``model``."""
    if tp.shard_dim(embed) != 0:
        return _Gather.apply(embed, tokens)
    V = embed.shape[0]
    local = tokens - dist_ctx.model_rank() * V
    valid = (local >= 0) & (local < V)
    rows = _Gather.apply(embed, local.clamp(0, V - 1), valid)
    return dist_ctx.reduce_from(rows, "model")


def _embed_tokens(cfg: ModelConfig, p, tokens, offset=0):
    """Token embeddings (B, S, d) in bf16; the encdec family adds the
    learned positions from ``offset`` on (the start clamped into the table,
    as the reference's ``dynamic_slice`` clamps it)."""
    x = _token_rows(p["embed"], tokens)
    if cfg.family == "encdec":
        S = tokens.shape[1]
        start = min(max(offset, 0), p["pos"].shape[0] - S)
        x = x + p["pos"][start:start + S]
    if cfg.name.startswith("gemma"):
        # gemma embeds are scaled; the reference multiplies in bf16 by the
        # scale rounded to bf16
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x.to(torch.bfloat16)


def _head(cfg: ModelConfig, p):
    """(the output projection, whether it is this rank's vocab shard)."""
    if cfg.tie_embeddings:
        return p["embed"].T, tp.shard_dim(p["embed"]) == 0
    return p["lm_head"], tp.shard_dim(p["lm_head"]) == 1


def _logits(cfg: ModelConfig, p, x):
    """The logits; this rank's vocab shard of them where the head is split
    (the train step over ``model``: column-parallel, ``loss_fn``'s
    vocab-parallel log-sum-exp takes them)."""
    x = apply_norm(cfg.norm, x, p["final_norm"])
    w, split = _head(cfg, p)
    if split:
        x = dist_ctx.copy_to(x)
    return x @ w


@spanned("repro_torch.encoder")
def _encoder_forward(cfg: ModelConfig, p, frames):
    """Whisper's encoder over ``frames`` (B, n_ctx, d), the audio stub's
    precomputed embeddings: the sinusoid table added in float32, then bf16
    blocks of non-causal self-attention (the flash kernel) and MLP, then
    the encoder's final norm."""
    x = (frames.float() + sinusoid_positions(frames.shape[1], cfg.d_model,
                                             frames.device)[None])
    x = x.to(torch.bfloat16)

    def block(x, pl):
        h, _ = attn.gqa_forward(pl["attn"],
                                apply_norm(cfg.norm, x, pl["norm1"]),
                                None, None, cfg=cfg, causal=False)
        x = x + h
        return x + mlp_apply(pl["mlp"], apply_norm(cfg.norm, x, pl["norm2"]),
                             cfg.activation)
    remat = _recorded(p["encoder"], x)
    for pl in p["encoder"]["layers"]:
        x = _run(remat, block, x, pl)
    return apply_norm(cfg.norm, x, p["encoder"]["final_norm"])


def _prepare_inputs(cfg: ModelConfig, p, batch):
    """(x, xa): the decoder's input embeddings (the vlm family's bf16 patch
    embeddings ahead of its tokens) and the encdec family's encoder output
    (else None)."""
    x = _embed_tokens(cfg, p, batch["tokens"])
    xa = None
    if cfg.family == "encdec":
        xa = _encoder_forward(cfg, p, batch["frames"])
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x, xa


def _ffn(cfg: ModelConfig, pl, x):
    """A block's MLP, or its MoE: returns (out, aux dict or None)."""
    if "moe" in pl:
        return moe_mod.moe_apply(pl["moe"], x, cfg)
    return mlp_apply(pl["mlp"], x, cfg.activation), None


def _mamba_blocks(cfg: ModelConfig, layers, x, states, remat=False):
    """Runs the Mamba blocks ``layers`` over the sequence x (checkpointed
    with ``remat``), appending each block's final state dict(conv, ssm) to
    ``states``; returns x.  Mamba1 takes ``PerfFlags.ssm_impl``."""
    forward = _mamba(cfg)[1]
    kw = {"impl": dist_ctx.perf_flags().ssm_impl} \
        if cfg.ssm.version == 1 else {}

    def block(x, pl):
        h, st = forward(pl["ssm"], _norm(cfg, x, pl["norm1"]), cfg, **kw)
        return x + h, st
    for pl in layers:
        x, st = _run(remat, block, x, pl)
        states.append(st)
    return x


def _shared_block(cfg: ModelConfig, shared, x, attend):
    """The hybrid family's shared block: attention (``attend(p, h)`` ->
    (out, state)), then the MLP; returns (x, the attention's state)."""
    h, st = attend(shared["attn"], _norm(cfg, x, shared["norm1"]))
    x = x + h
    x = x + mlp_apply(shared["mlp"], _norm(cfg, x, shared["norm2"]),
                      cfg.activation)
    return x, st


def _norm(cfg: ModelConfig, x, scale):
    """A block's norm of the residual stream; under the sequence-sharded
    residual each rank normalizes its slice of the sequence, so that the
    scale's gradient is summed over ``model`` (``copy_to``)."""
    if dist_ctx.seq_sharded():
        scale = dist_ctx.copy_to(scale)
    return apply_norm(cfg.norm, x, scale)


def _backbone(cfg: ModelConfig, p, x, positions, xa=None):
    """Returns (x, (load_balance, router_z) averaged over the layers, [the
    state of each layer]): (k, v) in the dense, moe and vlm families, with
    ``xa`` (the encdec family's encoder output) (k, v, xk, xv), the
    cross-attention's keys and values after them; (c_kv,
    k_rope) with MLA, dict(conv, ssm) in the ssm family; in the hybrid
    family the pair ([dict(conv, ssm) of each Mamba2 block], [(k, v) of
    each superblock's shared attention]).  The aux terms are 0 without MoE
    layers."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _recorded(p, x)
    if cfg.family == "ssm":
        states = []
        with _seq_sharded(x):
            x = tp.seq_whole(_mamba_blocks(cfg, p["layers"],
                                           tp.seq_shards(x), states, remat))
        return x, (zero, zero), states
    cos, sin = _rope_for(cfg, positions)
    if cfg.family == "hybrid":
        k = cfg.hybrid_attn_every
        states, kvs = [], []

        def attend(pa, h):
            return attn.gqa_forward(pa, h, cos, sin, cfg=cfg, causal=True)
        for sb in range(cfg.n_layers // k):
            x = _mamba_blocks(cfg, p["layers"][sb * k:(sb + 1) * k], x,
                              states, remat)
            x, kv = _run(remat, _shared_block, cfg, p["shared_attn"], x,
                         attend)
            kvs.append(kv)
        return x, (zero, zero), (states, kvs)
    # the reference's static-window path: a local layer's window is static
    static = (dist_ctx.perf_flags().windowed_attention
              and cfg.local_global_ratio > 0 and cfg.mla is None
              and xa is None and cfg.window > 0)

    def block(x, pl, window):
        h_in = _norm(cfg, x, pl["norm1"])
        if cfg.mla is not None:
            h, kv = attn.mla_forward(pl["attn"], h_in, cos, sin, cfg=cfg)
        else:
            h, kv = attn.gqa_forward(pl["attn"], h_in, cos, sin, cfg=cfg,
                                     causal=True, window=window,
                                     static_window=window if static else None)
        x = x + h
        if xa is not None:
            h, xkv = attn.gqa_forward(pl["xattn"],
                                      _norm(cfg, x, pl["norm_x"]),
                                      None, None, cfg=cfg, causal=False,
                                      xa=xa)
            x = x + h
            kv = kv + xkv
        h, aux = _ffn(cfg, pl, _norm(cfg, x, pl["norm2"]))
        return x + h, kv, aux

    kvs, lb, rz = [], zero, zero
    with _seq_sharded(x):
        x = tp.seq_shards(x)
        for pl, window in zip(p["layers"], _window_schedule(cfg)):
            x, kv, aux = _run(remat, block, x, pl, window)
            if aux is not None:
                lb, rz = lb + aux["load_balance"], rz + aux["router_z"]
            kvs.append(kv)
        x = tp.seq_whole(x)
    L = cfg.n_layers
    return x, (lb / L, rz / L), kvs


def _seq_sharded(x):
    """The blocks' region of the sequence-sharded residual
    (``PerfFlags.seq_sharded_residual``, where the reference constrains the
    residual to ``("batch", "seq_model", None)`` at each block): on in the
    train step over a ``model`` axis where the active rules shard
    ``seq_model`` over it and the sequence of ``x`` divides
    (``tp.seq_shards`` / ``tp.seq_whole`` then cut and gather it); off a
    region that changes nothing."""
    return dist_ctx.seq_sharded_region(tp.seq_shardable(x.shape[1]))


# ---------------------------------------------------------------------------
# training


def train_forward(cfg: ModelConfig, params, batch):
    """Logits (B, S, V) at every token position (the vlm family's patches
    dropped) and the aux dict (load_balance, router_z: the MoE layers'
    terms averaged over the layers, 0 elsewhere).  ``batch`` as in
    ``prefill_forward``."""
    _check_family(cfg)
    x, xa = _prepare_inputs(cfg, params, batch)
    x, (lb, rz), _ = _backbone(cfg, params, x,
                               torch.arange(x.shape[1], device=x.device),
                               xa=xa)
    if cfg.family == "vlm":
        x = x[:, cfg.n_patches:]
    return _logits(cfg, params, x), {"load_balance": lb, "router_z": rz}


def loss_fn(cfg: ModelConfig, params, batch):
    """(loss, metrics): the next-token NLL of ``batch["labels"]`` (B, S),
    plus the z-loss 1e-4 mean(logsumexp^2) and, with MoE, the aux terms at
    their coefficients, all in float32, as the reference's."""
    logits, aux = train_forward(cfg, params, batch)
    logits = logits.float()
    labels = batch["labels"].long()
    if _head(cfg, params)[1]:
        logz, label_logit = _vocab_parallel_terms(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        label_logit = logits.gather(-1, labels[..., None])[..., 0]
    nll = (logz - label_logit).mean()
    zloss = 1e-4 * (logz ** 2).mean()
    moe_loss = torch.zeros((), dtype=torch.float32, device=logits.device)
    if cfg.moe is not None:
        moe_loss = (cfg.moe.aux_loss_coef * aux["load_balance"]
                    + cfg.moe.router_z_coef * aux["router_z"])
    loss = nll + zloss + moe_loss
    return loss, {"loss": loss, "nll": nll, "zloss": zloss,
                  "moe_loss": moe_loss}


def _vocab_parallel_terms(logits, labels):
    """(logsumexp, the label's logit) over the whole vocab from this rank's
    shard of the logits (B, S, V / model), float32: the global max by an
    all-reduce (max; no gradient), the sum of exponentials and the label's
    logit, from the shard that owns it, by ``reduce_from``."""
    V = logits.shape[-1]
    mx = logits.detach().amax(-1)
    dist_ctx.all_reduce(mx, "model", op="max")
    total = dist_ctx.reduce_from(torch.exp(logits - mx[..., None]).sum(-1),
                                 "model")
    local = labels - dist_ctx.model_rank() * V
    valid = (local >= 0) & (local < V)
    picked = logits.gather(-1, local.clamp(0, V - 1)[..., None])[..., 0]
    return torch.log(total) + mx, dist_ctx.reduce_from(
        torch.where(valid, picked, 0.0), "model")


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode


def _kv_cache(n_layers, cfg: ModelConfig, batch, max_seq, device):
    shape = (n_layers, batch, cfg.n_kv_heads, max_seq, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    device = resolve_device(device)
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        L = cfg.n_layers
        if s.version == 1:
            conv, state = (L, batch, d_in, s.d_conv - 1), \
                (L, batch, d_in, s.d_state)
        else:
            conv, state = (L, batch, d_in + 2 * s.d_state, s.d_conv - 1), \
                (L, batch, s.n_heads, s.head_dim, s.d_state)
        c = {"conv": torch.zeros(conv, dtype=torch.bfloat16, device=device),
             "ssm": torch.zeros(state, dtype=torch.float32, device=device)}
        if cfg.family == "hybrid":
            c.update(_kv_cache(L // cfg.hybrid_attn_every, cfg, batch,
                               max_seq, device))
        return c
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": torch.zeros(cfg.n_layers, batch, max_seq,
                                   m.kv_lora_rank, dtype=torch.bfloat16,
                                   device=device),
                "krope": torch.zeros(cfg.n_layers, batch, max_seq,
                                     m.qk_rope_dim, dtype=torch.bfloat16,
                                     device=device)}
    c = _kv_cache(cfg.n_layers, cfg, batch, max_seq, device)
    if cfg.family == "encdec":
        xkv = _kv_cache(cfg.n_layers, cfg, batch, cfg.encoder.n_ctx, device)
        c.update(xk=xkv["k"], xv=xkv["v"])
    return c


def cache_axes(cfg: ModelConfig, batch: int, max_seq: int) -> Dict:
    """The logical axes of ``init_cache(cfg, batch, max_seq)``'s leaves,
    the reference's (the caches keep its stacked layouts)."""
    kv = ("layers", "batch", "kv_heads", "kv_seq", "head_dim")
    if cfg.family in ("ssm", "hybrid"):
        c = {"conv": ("layers", "batch", "d_inner", None),
             "ssm": ("layers", "batch", "d_inner", None)
             if cfg.ssm.version == 1
             else ("layers", "batch", "ssm_heads", None, None)}
        if cfg.family == "hybrid":
            c.update(k=kv, v=kv)
        return c
    if cfg.mla is not None:
        return {"ckv": ("layers", "batch", "kv_seq", "kv_lora"),
                "krope": ("layers", "batch", "kv_seq", None)}
    c = {"k": kv, "v": kv}
    if cfg.family == "encdec":
        xkv = ("layers", "batch", "kv_heads", None, "head_dim")
        c.update(xk=xkv, xv=xkv)
    return c


def prefill_forward(cfg: ModelConfig, params, batch,
                    max_seq: Optional[int] = None, layout=None):
    """Runs the full prompt, returns (last-token logits (B, 1, V), filled
    cache).  ``batch["tokens"]``: (B, S) integer tensor on the params'
    device; the encdec family also takes ``batch["frames"]`` (B, n_ctx, d)
    and the vlm family ``batch["patches"]`` (B, n_patches, d), whose
    positions come first, so that the prompt is n_patches + S long.

    ``layout`` (the serving steps on the rules' shards, ``serve.step``):
    {cache key: (its logical axes, its ``PartitionSpec``)}; the cache is
    then this rank's shard of each leaf (``local_cache``), each layer's
    state cut to it as it is written (``_put_state``)."""
    _check_family(cfg)
    x, xa = _prepare_inputs(cfg, params, batch)
    B, S = x.shape[:2]
    max_seq = max(max_seq or S, S)
    x, _, states = _backbone(cfg, params, x,
                             torch.arange(S, device=x.device), xa=xa)
    if layout is not None:
        return _logits(cfg, params, x[:, -1:]), _sharded_cache(
            cfg, states, B, max_seq, layout, x.device)
    cache = init_cache(cfg, B, max_seq, x.device)
    if cfg.family == "hybrid":
        # Mamba2 block i of superblock sb is layer sb * k + i, the order of
        # the reference's (nsb, k, ...) -> (L, ...) reshape
        states, kvs = states
        for sb, (k, v) in enumerate(kvs):
            cache["k"][sb, :, :, :S], cache["v"][sb, :, :, :S] = k, v
    for li, st in enumerate(states):
        if cfg.family in ("ssm", "hybrid"):
            cache["conv"][li] = st["conv"]
            cache["ssm"][li] = st["ssm"]
        elif cfg.mla is not None:
            cache["ckv"][li, :, :S], cache["krope"][li, :, :S] = st
        else:
            cache["k"][li, :, :, :S], cache["v"][li, :, :, :S] = st[:2]
            if cfg.family == "encdec":
                cache["xk"][li], cache["xv"][li] = st[2:]
    return _logits(cfg, params, x[:, -1:]), cache


# ---------------------------------------------------------------------------
# the cache on the rules' shards (the serving steps over a mesh)


def local_cache(cfg: ModelConfig, batch: int, max_seq: int, layout,
                device):
    """This rank's shard of ``init_cache(cfg, batch, max_seq)`` (``batch``
    the global batch) under ``layout`` ({key: (axes, spec)}): each leaf's
    dimensions divided by the sizes of the mesh axes its spec names,
    zeros."""
    full = init_cache(cfg, batch, max_seq, "meta")
    out = {}
    for key, t in full.items():
        spec = layout[key][1]
        shape = [n // dist_ctx.shard_of(spec[d] if d < len(spec) else None)[1]
                 for d, n in enumerate(t.shape)]
        out[key] = torch.zeros(shape, dtype=t.dtype, device=device)
    return out


def _put_state(leaf, li, value, axes, spec):
    """``leaf[li]`` (a layer of this rank's cache shard) <- ``value``, that
    layer's state, cut to the shard: along a dimension the rank computed
    whole (its size is not the shard's) its slice is taken; along
    ``kv_seq``, the prompt's positions that fall in the rank's slice of
    the cache."""
    idx = [li]
    for d in range(1, len(axes)):
        vd = d - 1
        entry = spec[d] if d < len(spec) else None
        if axes[d] == "kv_seq":
            start = dist_ctx.shard_of(entry)[0] * leaf.shape[d]
            n = value.shape[vd]
            lo, hi = min(start, n), min(start + leaf.shape[d], n)
            value = value.narrow(vd, lo, hi - lo)
            idx.append(slice(0, hi - lo))
            continue
        if entry is not None and value.shape[vd] != leaf.shape[d]:
            value = value.narrow(
                vd, dist_ctx.shard_of(entry)[0] * leaf.shape[d],
                leaf.shape[d])
        idx.append(slice(None))
    leaf[tuple(idx)] = value


def _sharded_cache(cfg: ModelConfig, states, B, max_seq, layout, device):
    """``prefill_forward``'s cache on the rules' shards: ``local_cache`` of
    the global batch, each layer's state written by ``_put_state``.  A
    Mamba2 state computed on the rank's heads is first made whole
    (``ssm.mamba2_whole_state``), since the rules' layout of it is not the
    rank's heads."""
    spec_b = layout[next(iter(layout))][1]
    B_global = B * dist_ctx.shard_of(spec_b[1] if len(spec_b) > 1
                                     else None)[1]
    cache = local_cache(cfg, B_global, max_seq, layout, device)

    def put(key, li, value):
        _put_state(cache[key], li, value, *layout[key])
    if cfg.family == "hybrid":
        states, kvs = states
        for sb, (k, v) in enumerate(kvs):
            put("k", sb, k)
            put("v", sb, v)
    for li, st in enumerate(states):
        if cfg.family in ("ssm", "hybrid"):
            if cfg.ssm.version == 2:
                st = ssm_mod.mamba2_whole_state(st, cfg)
            put("conv", li, st["conv"])
            put("ssm", li, st["ssm"])
        elif cfg.mla is not None:
            put("ckv", li, st[0])
            put("krope", li, st[1])
        else:
            put("k", li, st[0])
            put("v", li, st[1])
            if cfg.family == "encdec":
                put("xk", li, st[2])
                put("xv", li, st[3])
    return cache


def _seq_split(layout, key, cache):
    """(mesh axes, start) of this rank's slice of ``cache[key]``'s
    positions where the layout splits ``kv_seq``; None where it does not
    (or off the rules' shards)."""
    if layout is None:
        return None
    axes, spec = layout[key]
    d = axes.index("kv_seq")
    entry = spec[d] if d < len(spec) else None
    if entry is None:
        return None
    return entry, dist_ctx.shard_of(entry)[0] * cache[key].shape[d]


def _mamba_steps(cfg: ModelConfig, params, cache, x, layers):
    """One decode step through the Mamba blocks ``layers`` (indices), their
    ``conv`` and ``ssm`` caches updated in place; returns x."""
    decode = _mamba(cfg)[2]
    for li in layers:
        pl = params["layers"][li]
        h, new = decode(pl["ssm"], apply_norm(cfg.norm, x, pl["norm1"]),
                        {"conv": cache["conv"][li], "ssm": cache["ssm"][li]},
                        cfg)
        x = x + h
        cache["conv"][li] = new["conv"]
        cache["ssm"][li] = new["ssm"]
    return x


def decode_forward(cfg: ModelConfig, params, cache, tokens, pos: int,
                   layout=None):
    """One decode step.  tokens: (B, 1); pos: the position of this token.
    Returns (logits (B, 1, V), cache), the cache updated in place.
    ``layout``: as ``prefill_forward``'s; the cache is then this rank's
    shard of it, and attention computes on each layout the rules give
    (``attention.gqa_decode``, ``attention.mla_decode``)."""
    _check_family(cfg)
    x = _embed_tokens(cfg, params, tokens, pos)
    if cfg.family == "ssm":
        x = _mamba_steps(cfg, params, cache, x, range(cfg.n_layers))
        return _logits(cfg, params, x), cache
    cos, sin = _rope_for(cfg, torch.full((1,), pos, device=x.device))
    if cfg.family == "hybrid":
        k = cfg.hybrid_attn_every
        for sb in range(cfg.n_layers // k):
            x = _mamba_steps(cfg, params, cache, x,
                             range(sb * k, (sb + 1) * k))
            x, _ = _shared_block(
                cfg, params["shared_attn"], x,
                lambda pa, h, sb=sb: attn.gqa_decode(
                    pa, h, cache["k"][sb], cache["v"][sb], cos, sin,
                    cfg=cfg, pos=pos,
                    seq=_seq_split(layout, "k", cache))[:2])
        return _logits(cfg, params, x), cache
    # the reference's static-window decode: a local layer reads only the
    # window's slice of its cache
    static = (dist_ctx.perf_flags().windowed_attention and cfg.mla is None
              and cfg.family != "encdec" and cfg.local_global_ratio > 0
              and cfg.window > 0)
    for li, (pl, window) in enumerate(zip(params["layers"],
                                          _window_schedule(cfg))):
        h_in = apply_norm(cfg.norm, x, pl["norm1"])
        if cfg.mla is not None:
            h, _, _ = attn.mla_decode(pl["attn"], h_in, cache["ckv"][li],
                                      cache["krope"][li], cos, sin, cfg=cfg,
                                      pos=pos,
                                      seq=_seq_split(layout, "ckv", cache))
        else:
            h, _, _ = attn.gqa_decode(
                pl["attn"], h_in, cache["k"][li], cache["v"][li], cos, sin,
                cfg=cfg, pos=pos, window=window,
                static_window=window if static else None,
                seq=_seq_split(layout, "k", cache))
        x = x + h
        if cfg.family == "encdec":
            with span("repro_torch.attn.cross_decode"):
                h, _, _ = attn.gqa_decode(
                    pl["xattn"], apply_norm(cfg.norm, x, pl["norm_x"]), None,
                    None, None, None, cfg=cfg, pos=pos,
                    xa_kv=(cache["xk"][li], cache["xv"][li]))
            x = x + h
        x = x + _ffn(cfg, pl, apply_norm(cfg.norm, x, pl["norm2"]))[0]
    return _logits(cfg, params, x), cache
