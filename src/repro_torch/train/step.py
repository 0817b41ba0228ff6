"""Training step: loss and gradients, then clipping and AdamW, with
optional microbatch gradient accumulation; the port's copy of the JAX
package's ``repro.train.step``.

The model's blocks run under activation checkpointing whenever autograd
records them (``models.transformer``), as the reference remats its scan
bodies.  On the card attention runs the flash kernel forward and its plain
gradient backward (``kernels.ops``).

On a mesh (``dist.context.set_mesh``) the step computes what the
reference's jit computes on the global batch under the rules' shardings:
one device's step on the whole batch.  Each rank takes its shard of the
global batch by the active rules' ``batch`` entry (``dist.sharding``;
``dp_axes()`` without rules), and the gradients and metrics are averaged
over ``dp_axes()`` before clipping.  The model runs under
``dist.context.global_batch``, so that what it computes over the batch as
a whole (the MoE's expert capacity, slot order and aux terms) is the
global batch's.

On a mesh whose ``model`` axis is larger than 1 the params and AdamW's
``m``/``v`` are ``DTensor``s with the rules' placements
(``Rules.tree_shardings(param_axes(cfg), params)``, placed by
``dist.sharding.distribute``; ``ckpt.load_checkpoint`` restores them so):
each rank holds only its shard of every leaf the rules split.  The step is
manual SPMD on the local shards (``dist.sharding.local_shards``, each
marked with its split dimension), in a region that binds ``model``: heads,
``d_ff``, vocab, experts and ``d_inner`` compute on their shards, and every
collective is written out (``dist.tp``, ``dist.context.copy_to`` and its
pairs; the vocab-parallel embedding and loss in ``models.transformer``).
The clip sums a split leaf's squares over ``model``; AdamW is elementwise
on the shards, which are updated in place.  With ``model`` 1 the params
are plain tensors and the step is the data-parallel one.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from repro_torch.core import tree
from repro_torch.core.config import ModelConfig
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import sharding, tp
from repro_torch.dist.sharding import active_rules
from repro_torch.models import transformer as T
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule)


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0
    weight_decay: float = 0.1
    n_microbatches: int = 1     # >1 => gradient accumulation


def init_train_state(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """(params, opt_state): random params from ``seed`` on ``device`` and
    AdamW's zero state.  The reference also returns its logical-axes trees;
    the port's are ``models.transformer.param_axes(cfg)``."""
    params = T.init_params(cfg, seed, device)
    return params, adamw_init(params)


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics).  The step updates ``params`` and ``opt_state`` in
    place.  ``batch``: tensors on the params' device (``tokens``,
    ``labels``, and the stub frontends' ``frames`` or ``patches``); with
    ``n_microbatches`` > 1 it is split along the batch, the float32
    gradients summed and averaged, and the metrics averaged.  Metrics:
    ``loss``, ``nll``, ``zloss``, ``moe_loss``, ``grad_norm`` (0-d tensors,
    the norm before clipping) and ``lr`` (a float)."""
    lr_fn = cosine_schedule(tc.lr, tc.warmup, tc.total_steps)

    def grads_of(params, leaves, batch):
        loss, metrics = T.loss_fn(cfg, params, batch)
        return metrics, torch.autograd.grad(loss, leaves)

    def accumulate(params, batch):
        leaves = tree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        n = tc.n_microbatches
        if n > 1:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            sums = {}
            for i in range(n):
                micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                         for k, v in batch.items()}
                metrics, gs = grads_of(params, leaves, micro)
                for acc, g in zip(grads, gs):
                    acc.add_(g)
                for k, v in metrics.items():
                    sums[k] = sums.get(k, 0) + v.detach()
            for acc in grads:
                acc.div_(n)
            metrics = {k: v / n for k, v in sums.items()}
        else:
            metrics, grads = grads_of(params, leaves, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics, grads

    def train_step(params, opt_state, batch, step):
        mesh = dist_ctx.get_mesh()
        dp = dist_ctx.dp_axes() if mesh is not None else None
        entry = None
        if dp is not None:
            entry = _batch_entry()
            batch = _batch_shard(batch, entry, tc.n_microbatches)
        local, opt, sharded = params, opt_state, None
        region = contextlib.nullcontext()
        if mesh is not None and dist_ctx.model_size() > 1:
            local, opt = _local_state(params, opt_state)
            sharded = [tp.marked_dim(p) is not None
                       for p in tree.leaves(local)]
            region = dist_ctx.bound_axes("model")
        with dist_ctx.global_batch(entry), region:
            metrics, grads = accumulate(local, batch)
        if sharded is not None:
            for p in tree.leaves(local):   # the DTensors' own storage
                p.requires_grad_(False)
        if dp is not None:
            means = _mean_over([*grads, *metrics.values()], dp)
            grads, metrics = means[:len(grads)], dict(
                zip(metrics, means[len(grads):]))
        clip = {} if sharded is None else {"sharded": sharded}
        grads, gnorm = clip_by_global_norm(list(grads), tc.grad_clip, **clip)
        lr = lr_fn(step)
        adamw_update(grads, opt, local, lr=lr, weight_decay=tc.weight_decay)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def _local_state(params, opt_state):
    """The local shards of ``params`` and of AdamW's moments, on a mesh
    whose ``model`` axis is larger than 1, where they must be the rules'
    ``DTensor``s."""
    if not all(sharding.is_dtensor(p) for p in tree.leaves(params)):
        raise ValueError(
            "on a 'model' axis larger than 1 the train step takes the params "
            "and moments as DTensors with the rules' placements "
            "(dist.sharding.distribute)")
    return sharding.local_shards(params), dict(
        opt_state, m=sharding.local_shards(opt_state["m"]),
        v=sharding.local_shards(opt_state["v"]))


def _batch_entry():
    """The spec entry the global batch is sharded by: the active rules'
    ``batch`` entry, ``dp_axes()`` without rules."""
    rules = active_rules()
    return rules.table.get("batch") if rules is not None \
        else dist_ctx.dp_axes()


def _batch_shard(batch, entry, n_microbatches):
    """This rank's shard of the global ``batch`` along dim 0 by ``entry``
    (the whole batch where it is None): of each of the ``n_microbatches``
    global microbatches, its share, so that the step's microbatch i is
    this rank's shard of the global microbatch i."""
    index, count = dist_ctx.shard_of(entry)
    if count == 1:
        return batch
    n = n_microbatches
    return {k: v.reshape(n, count, v.shape[0] // (n * count), *v.shape[1:])
            [:, index].reshape(v.shape[0] // count, *v.shape[1:])
            for k, v in batch.items()}


def _mean_over(tensors, axes):
    """``tensors`` averaged over the mesh axes ``axes`` in one float32
    ``all_reduce``; each comes back in its own dtype."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist_ctx.all_reduce(flat, axes, op="mean")
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t).to(t.dtype))
        i += t.numel()
    return out
