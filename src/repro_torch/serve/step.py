"""Serving steps: batched prefill and single-token greedy decode.

Off a mesh the steps run ``models.transformer``'s ``prefill_forward`` and
``decode_forward`` on whole tensors.

On the rules' shards: with a mesh (``dist.context.set_mesh``) and rules
(``dist.sharding.set_active_rules``) installed, the steps compute what the
reference's ``jax.jit`` of them computes under the rules' param and cache
shardings, as manual SPMD on each rank's shards:

  * where the mesh's ``model`` axis is larger than 1 the params are the
    rules' ``DTensor``s (``dist.sharding.distribute``), as in the train
    step, and the model computes on their local shards in a region that
    binds ``model`` (heads, ``d_ff``, experts, ``d_inner`` and the
    vocab-parallel embedding and logits, ``dist.tp``); with ``model`` 1
    they are plain tensors;
  * the cache is placed by ``Rules.tree_shardings(cache_axes(...))``: the
    prefill step writes each rank's shard in that layout and returns the
    cache as ``DTensor``s, which the decode step updates in place.  Decode
    computes on every layout the rules give (``models.attention``:
    KV heads or ``head_dim`` over ``model``, ``kv_seq`` over ``data``;
    MLA's compressed cache; the Mamba states on ``d_inner``;
    ``models.ssm``);
  * the global batch is sharded by the rules' ``batch`` entry, each rank
    computing its shard under ``dist.context.global_batch`` (the MoE's
    routing is the global batch's); the tokens that decode takes and
    returns are the global batch's, the same on every rank;
  * the logits come back as a ``DTensor`` (``.full_tensor()`` gathers
    them), and ``greedy`` takes the argmax of the vocab-parallel logits
    across ``model`` with the lowest index on a tie, as ``argmax`` does.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core import tree
from repro_torch.core.spans import spanned
from repro_torch.core.config import ModelConfig
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import sharding
from repro_torch.models import transformer as T


def greedy(logits):
    """(B, S, V) logits -> (B, 1) index of the first maximum of the last
    position (``jnp.argmax``'s tie rule)."""
    return torch.argmax(logits[:, -1], dim=-1, keepdim=True)


def greedy_vocab_parallel(logits):
    """``greedy`` of logits whose last dimension is this rank's shard of
    the vocab over ``model`` (in rank order): each rank's first maximum and
    its value, gathered; the token is the first rank's whose value is the
    largest, so that a tie goes to the lowest index."""
    last = logits[:, -1]
    V = last.shape[-1]
    idx = torch.argmax(last, dim=-1)
    val = last.gather(-1, idx[:, None])[:, 0].double()
    idx = (idx + dist_ctx.model_rank() * V).double()
    both = dist_ctx.gather_from(torch.stack([val, idx])[None], "model", 0)
    first = (both[:, 0] == both[:, 0].amax(0)).double().argmax(0)
    return both[:, 1].gather(0, first[None])[0].long()[:, None]


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


def _on_rules():
    """The active rules where the steps run on their shards: a mesh and
    rules installed (else None)."""
    rules = sharding.active_rules()
    if dist_ctx.get_mesh() is None or rules is None \
            or rules.mesh is None:
        return None
    return rules


def _region(params):
    """(the params the model computes on, the region it runs in): the
    local shards in a region that binds ``model`` where that axis is
    larger than 1, else ``params`` and no region."""
    if dist_ctx.model_size() <= 1:
        return params, contextlib.nullcontext()
    if not all(sharding.is_dtensor(p) for p in tree.leaves(params)):
        raise ValueError(
            "on a 'model' axis larger than 1 the serving steps take the "
            "params as DTensors with the rules' placements "
            "(dist.sharding.distribute)")
    return sharding.local_shards(params), dist_ctx.bound_axes("model")


def _layout(cfg, rules, batch, max_seq):
    """{cache key: (logical axes, PartitionSpec)} of the cache of the
    global ``batch`` and ``max_seq`` positions under ``rules``."""
    axes = T.cache_axes(cfg, batch, max_seq)
    full = T.init_cache(cfg, batch, max_seq, "meta")
    return {k: (axes[k], rules.spec_for(axes[k], tuple(full[k].shape)))
            for k in full}


def _as_dtensor(local, rules, spec, shape):
    """``local``, this rank's shard of a contiguous tensor of ``shape``
    laid out by ``spec``, as a ``DTensor``."""
    from torch.distributed.tensor import DTensor
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, rules.mesh, rules.placements(spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _shard_batch(batch, entry):
    index, count = dist_ctx.shard_of(entry)
    if count == 1:
        return batch
    return {k: v.chunk(count, 0)[index] for k, v in batch.items()}


def _whole_batch(t, entry):
    """``t``, this rank's shard of the global batch along dim 0 by
    ``entry``, gathered (the first axis the most major)."""
    for name in reversed(dist_ctx.axis_names(entry)):
        if dist_ctx.mesh_axis_size(name) > 1:
            t = dist_ctx.gather_from(t.contiguous(), name, 0)
    return t


def _logits_dtensor(cfg, rules, logits, B):
    shape = (B, logits.shape[1], cfg.vocab)
    spec = rules.spec_for(("batch", None, "vocab"), shape)
    return _as_dtensor(logits, rules, spec, shape)


def _mesh_prefill(cfg, params, batch, max_seq, rules):
    entry = rules.table.get("batch")
    B = batch["tokens"].shape[0]
    S = prompt_positions(cfg, batch["tokens"].shape[1])
    max_seq = max(max_seq or S, S)
    layout = _layout(cfg, rules, B, max_seq)
    local, region = _region(params)
    with torch.no_grad(), dist_ctx.global_batch(entry), region:
        logits, cache = T.prefill_forward(cfg, local,
                                          _shard_batch(batch, entry),
                                          max_seq=max_seq, layout=layout)
    full = T.init_cache(cfg, B, max_seq, "meta")
    cache = {k: _as_dtensor(v, rules, layout[k][1], tuple(full[k].shape))
             for k, v in cache.items()}
    return _logits_dtensor(cfg, rules, logits, B), cache


def _mesh_decode(cfg, params, cache, tokens, pos, rules):
    entry = rules.table.get("batch")
    B = next(iter(cache.values())).shape[1]
    max_seq = cache["k"].shape[3] if "k" in cache \
        else cache["ckv"].shape[2] if "ckv" in cache else 1
    layout = _layout(cfg, rules, B, max_seq)
    local, region = _region(params)
    shards = {k: v.to_local() for k, v in cache.items()}
    with torch.no_grad(), dist_ctx.global_batch(entry), region:
        logits, _ = T.decode_forward(cfg, local, shards,
                                     _shard_batch({"t": tokens}, entry)["t"],
                                     pos, layout=layout)
        vocab_split = logits.shape[-1] < cfg.vocab
        nxt = greedy_vocab_parallel(logits) if vocab_split \
            else greedy(logits)
        nxt = _whole_batch(nxt, entry)
    return nxt, cache, _logits_dtensor(cfg, rules, logits, B)


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    @spanned("repro_torch.serve.prefill")
    def prefill_step(params, batch):
        """Returns (last-token logits (B, 1, V), cache); on the rules'
        shards the logits and the cache as ``DTensor``s."""
        rules = _on_rules()
        if rules is not None:
            return _mesh_prefill(cfg, params, batch, max_seq, rules)
        return T.prefill_forward(cfg, params, batch, max_seq=max_seq)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @spanned("repro_torch.serve.decode")
    def decode_step(params, cache, tokens, pos):
        """Returns (next tokens (B, 1), cache, logits): the logits are
        returned too so that the caller can check them.  On the rules'
        shards ``cache`` is the prefill step's ``DTensor``s, updated in
        place, ``tokens`` the global batch's, and the logits a
        ``DTensor``."""
        rules = _on_rules()
        if rules is not None:
            return _mesh_decode(cfg, params, cache, tokens, pos, rules)
        logits, cache = T.decode_forward(cfg, params, cache, tokens, pos)
        return greedy(logits), cache, logits
    return decode_step
