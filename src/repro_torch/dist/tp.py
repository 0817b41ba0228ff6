"""Tensor-parallel helpers: the port's copy of the JAX package's
``repro.dist.tp``, and the regions of the train step over a ``model`` axis.

A rank's shard of a leaf that the rules split over ``model`` carries the
tensor dimension it is split along, and a whole leaf carries None
(``mark_shard``; the train step marks every leaf from its ``DTensor``
placements, ``dist.sharding.local_shards``, the one place that reads them).
Inside a region that binds ``model`` (``context.bound_axes``), ``shard_dim``
reads that mark, so the model code asks the placements, not the config,
whether a leaf is split; a weight there that carries no mark (a copy, cast
or slice of a leaf drops it) raises rather than pass a partial product for
the whole one.  A region is the Megatron pattern: the replicated
activation enters it through ``enter`` (``copy_to``: identity forward,
all-reduce backward), its column-parallel projections compute this rank's
heads / ``d_ff`` / channels, and the row-parallel projection ``tp_project``
closes it (``leave``: an all-reduce of the partial sums).  Under
``PerfFlags.seq_sharded_residual`` (``context.seq_sharded``) the residual
stream is sequence-sharded between blocks: the entry all-gathers the
sequence and the exit reduce-scatters it; a region whose weights are whole
gathers on entry and slices on exit.

Off a mesh, outside a bound region, or for a leaf marked whole, all of
this is the identity and ``tp_project`` is the plain product.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist import context as dist_ctx
from repro_torch.dist.sharding import active_rules

_SHARD_DIM = "_model_shard_dim"
_UNMARKED = object()


def mark_shard(t, dim: Optional[int]):
    """Marks ``t`` as this rank's contiguous shard of a leaf split over
    ``model`` along ``dim`` (None: ``t`` is the whole leaf); returns t."""
    setattr(t, _SHARD_DIM, dim)
    return t


def marked_dim(t) -> Optional[int]:
    """The dimension ``t`` was marked split along (None if not marked)."""
    return getattr(t, _SHARD_DIM, None)


def shard_dim(w) -> Optional[int]:
    """The dimension along which ``w`` is this rank's shard of a leaf split
    over a bound ``model`` axis larger than 1; None for a whole leaf, off
    a mesh or outside a region that binds ``model``.  Inside such a region
    ``w`` must carry a mark (``mark_shard``), else ValueError."""
    if dist_ctx.model_size() <= 1 or "model" not in dist_ctx.bound():
        return None
    dim = getattr(w, _SHARD_DIM, _UNMARKED)
    if dim is _UNMARKED:
        raise ValueError(
            f"a weight of shape {tuple(w.shape)} inside a region that binds "
            f"'model' carries no shard mark (dist.tp.mark_shard): pass the "
            f"leaf that dist.sharding.local_shards marked, or mark its copy")
    return dim


def seq_shardable(seq_len: int) -> bool:
    """Whether a residual stream of ``seq_len`` positions is sharded on the
    sequence: ``PerfFlags.seq_sharded_residual`` in a region that binds a
    ``model`` axis larger than 1, where the active rules shard
    ``seq_model`` over it and ``seq_len`` divides."""
    m = dist_ctx.model_size()
    if not dist_ctx.perf_flags().seq_sharded_residual or m <= 1 \
            or "model" not in dist_ctx.bound():
        return False
    rules = active_rules()
    return rules is not None and rules.table.get("seq_model") == "model" \
        and seq_len % m == 0


def seq_shards(x):
    """The residual stream ``x`` (B, S, d) cut to this rank's slice of the
    sequence in a sequence-sharded region (backward: the slices'
    gradients gathered); else ``x``."""
    return dist_ctx.scatter_to(x, "model", 1) if dist_ctx.seq_sharded() \
        else x


def seq_whole(x):
    """The reverse of ``seq_shards``: the slices gathered."""
    return dist_ctx.gather_from(x, "model", 1) if dist_ctx.seq_sharded() \
        else x


def enter(x, split: bool):
    """The residual stream ``x`` entering a region: ``split``, its ranks
    compute different parts (their gradients are summed), else each
    computes the whole.  Under the sequence-sharded residual the sequence
    (dim 1) is gathered first."""
    if dist_ctx.seq_sharded():
        return dist_ctx.gather_from(x, "model", 1, reduce_grad=split)
    return dist_ctx.copy_to(x) if split else x


def leave(y, split: bool):
    """A region's output back to the residual stream: with ``split`` ``y``
    is this rank's partial sum, reduced over ``model`` (in bf16 on the
    wire under ``bf16_tp_collectives``), else every rank's whole output.
    Under the sequence-sharded residual the rank keeps its slice of the
    sequence."""
    sp = dist_ctx.seq_sharded()
    if not split:
        return dist_ctx.scatter_to(y, "model", 1) if sp else y
    if sp:
        return dist_ctx.reduce_scatter_to(y, "model", 1)
    wire = torch.bfloat16 if dist_ctx.perf_flags().bf16_tp_collectives \
        else None
    return dist_ctx.reduce_from(y, "model", wire)


def part(w, dim: int):
    """This rank's contiguous 1/n of ``w`` along ``dim`` in a split region:
    ``w`` itself where it is that shard, else the slice of the whole leaf
    (its gradient summed over the ranks, ``copy_to``)."""
    if shard_dim(w) == dim:
        return w
    return dist_ctx.rank_slice(dist_ctx.copy_to(w), "model", dim)


def whole(w, dim: int):
    """The whole leaf ``w`` in a split region whose ranks use different
    parts of it (a fused projection, gathered at use): gathered along
    ``dim`` where ``w`` is a shard, else through ``copy_to``; either way
    its gradient sums the ranks' parts."""
    if shard_dim(w) == dim:
        return dist_ctx.gather_from(w, "model", dim, reduce_grad=True)
    return dist_ctx.copy_to(w)


def tp_project(x, w):
    """x @ w closing a tensor-parallel region: where ``w`` is this rank's
    shard of its rows (the contraction dimension, d_ff / heads_x_dim /
    d_inner) over a bound ``model`` axis, the partial products are reduced
    (``leave``); under ``bf16_tp_collectives`` in bf16 on the wire.  Off a
    mesh, or for a whole ``w``, it is the plain product (sliced to this
    rank's sequence under the sequence-sharded residual)."""
    return leave(x @ w, shard_dim(w) == 0)
