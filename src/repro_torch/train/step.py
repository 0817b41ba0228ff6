"""Training step: loss and gradients, then clipping and AdamW, with
optional microbatch gradient accumulation; the port's copy of the JAX
package's ``repro.train.step``.

The model's blocks run under activation checkpointing whenever autograd
records them (``models.transformer``), as the reference remats its scan
bodies.  On the card attention runs the flash kernel forward and its plain
gradient backward (``kernels.ops``).

On a mesh (``dist.context.set_mesh``) whose ``model`` axis is 1, so that
the rules replicate every parameter, the step is data-parallel: each rank
takes its shard of the global batch by the active rules' ``batch`` entry
(``dist.sharding``; ``dp_axes()`` without rules), and the gradients and
metrics are averaged over ``dp_axes()`` before clipping.  The model runs
under ``dist.context.global_batch``, so that what it computes over the
batch as a whole (the MoE's expert capacity, slot order and aux terms)
is the global batch's.  The step so computes what the reference's jit
computes on the global batch under those rules: one device's step on the
whole batch.  A ``model`` axis larger than 1 is ROADMAP Queue 1 item 10b
(the step over sharded parameters) and raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import tree
from repro_torch.core.config import ModelConfig
from repro_torch.dist import context as dist_ctx
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
        dp = _data_parallel()
        entry = None
        if dp is not None:
            entry = _batch_entry()
            batch = _batch_shard(batch, entry, tc.n_microbatches)
        with dist_ctx.global_batch(entry):
            metrics, grads = accumulate(params, batch)
        if dp is not None:
            means = _mean_over([*grads, *metrics.values()], dp)
            grads, metrics = means[:len(grads)], dict(
                zip(metrics, means[len(grads):]))
        grads, gnorm = clip_by_global_norm(list(grads), tc.grad_clip)
        lr = lr_fn(step)
        adamw_update(grads, opt_state, params, lr=lr,
                     weight_decay=tc.weight_decay)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def _data_parallel():
    """The data-parallel axes of the active mesh (None off a mesh, or on
    one with no data axis larger than 1); raises on a ``model`` axis
    larger than 1."""
    if dist_ctx.get_mesh() is None:
        return None
    if dist_ctx.mesh_axis_size("model") > 1:
        raise NotImplementedError(
            "the train step over a 'model' axis larger than 1 (parameters "
            "sharded by the rules, DTensor and local_map) is ROADMAP Queue 1 "
            "item 10b")
    return dist_ctx.dp_axes()


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
