"""Optimizers (AdamW, SGD-momentum), gradient clipping, LR schedules: the
port's copy of the JAX package's ``repro.optim.optimizers``.

They work on the port's param trees (nested dicts and lists of tensors,
``repro_torch.core.tree``).  Optimizer states mirror the param tree: the
moments are float32 on each param's device.  Where the reference returns
new trees, the port updates params, states and gradients IN PLACE under
``torch.no_grad()`` and returns them, so that a step holds no second copy
of the model.  The arithmetic is the reference's, in float32, each result
cast back to its param's dtype.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.core import tree
from repro_torch.core.spans import spanned


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step): linear warmup to ``base_lr`` over ``warmup`` steps, then a
    cosine down to 0 at ``total``; a Python float."""
    def lr(step):
        step = float(step)
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return 0.5 * base_lr * (1 + math.cos(math.pi * frac))
    return lr


@spanned("repro_torch.optim.clip")
@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, sharded=None):
    """Scales every gradient of ``grads`` IN PLACE by min(1, max_norm /
    norm), norm the float32 L2 norm of all of them; returns (grads, norm),
    the norm a 0-d float32 tensor.  ``sharded`` (the train step over a
    ``model`` axis): a bool a leaf, whether it is this rank's shard of a
    leaf split over ``model``; those leaves' squares are summed over the
    axis, and a replicated leaf counts once."""
    leaves = tree.leaves(grads)
    sq = [g.float().square().sum() for g in leaves]
    if sharded is None:
        gn = torch.stack(sq).sum().sqrt()
    else:
        from repro_torch.dist import context as dist_ctx
        zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
        split = torch.stack([zero, *(q for q, s in zip(sq, sharded) if s)])
        split = dist_ctx.all_reduce(split.sum(), "model")
        gn = (torch.stack([zero, *(q for q, s in zip(sq, sharded) if not s)])
              .sum() + split).sqrt()
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale.to(g.device))
    return grads, gn


def _zeros32(params):
    """float32 zeros like each leaf (a ``DTensor`` leaf's with its
    placements: each rank holds its shard of the moments)."""
    return tree.map_tree(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _count(params):
    device = tree.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw_init(params) -> Dict[str, Any]:
    return {"m": _zeros32(params), "v": _zeros32(params),
            "count": _count(params)}


@spanned("repro_torch.optim.adamw")
@torch.no_grad()
def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """One AdamW step with bias correction and decoupled weight decay,
    applied IN PLACE to ``params`` and ``state``; returns (params, state)."""
    state["count"] += 1
    c = state["count"].float()
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c
    for g, m, v, p in zip(tree.leaves(grads), tree.leaves(state["m"]),
                          tree.leaves(state["v"]), tree.leaves(params)):
        g32 = g.float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        p32 = p.float()
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p32
        p.copy_(p32 - lr * step)
    return params, state


def sgd_init(params) -> Dict[str, Any]:
    return {"mom": _zeros32(params), "count": _count(params)}


@torch.no_grad()
def sgd_update(grads, state, params, *, lr, momentum=0.9):
    """One SGD-momentum step, IN PLACE; returns (params, state)."""
    for g, m, p in zip(tree.leaves(grads), tree.leaves(state["mom"]),
                       tree.leaves(params)):
        m.mul_(momentum).add_(g.float())
        p.copy_(p.float() - lr * m)
    state["count"] += 1
    return params, state
