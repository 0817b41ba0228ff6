"""Training step: loss and gradients, then clipping and AdamW, with
optional microbatch gradient accumulation; the port's copy of the JAX
package's ``repro.train.step``.

The model's blocks run under activation checkpointing whenever autograd
records them (``models.transformer``), as the reference remats its scan
bodies.  On the card attention runs the flash kernel forward and its plain
gradient backward (``kernels.ops``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import tree
from repro_torch.core.config import ModelConfig
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
    AdamW's zero state.  The reference also returns its logical-axes trees,
    which the port, on one device, has no use for."""
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

    def train_step(params, opt_state, batch, step):
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
        grads, gnorm = clip_by_global_norm(list(grads), tc.grad_clip)
        lr = lr_fn(step)
        adamw_update(grads, opt_state, params, lr=lr,
                     weight_decay=tc.weight_decay)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step
