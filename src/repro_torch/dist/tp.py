"""Tensor-parallel helpers: the port's copy of the JAX package's
``repro.dist.tp``.

``tp_project`` closes a TP region: the activation is sharded on its
contraction dimension (d_ff / heads_x_dim) over the 'model' axis, the down
projection produces partial sums, and the partials are reduced.  Off a
mesh, or where the axis is not bound by a manual region
(``context.bound_axes``), it is just the matmul; inside one, where each
rank holds its shard, it all-reduces over the axis's group itself, as the
reference psums under ``shard_map``.
"""
from __future__ import annotations

import torch

from repro_torch.dist import context as dist_ctx


def tp_project(x, w, axis_name: str = "model"):
    """x @ w, reduced over ``axis_name`` when that axis is bound; under
    ``bf16_tp_collectives`` the partials cross the wire in bf16."""
    out = x @ w
    if dist_ctx.mesh_axis_size(axis_name) > 1 \
            and axis_name in dist_ctx.bound():
        if dist_ctx.perf_flags().bf16_tp_collectives:
            out = dist_ctx.all_reduce(out.to(torch.bfloat16),
                                      axis_name).to(x.dtype)
        else:
            dist_ctx.all_reduce(out, axis_name)
    return out
