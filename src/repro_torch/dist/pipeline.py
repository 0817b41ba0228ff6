"""GPipe-style pipeline parallelism over a 'stage' mesh axis: the port's
copy of the JAX package's ``repro.dist.pipeline``.

``pipeline_apply`` runs S stages on the S ranks of the mesh's ``stage``
dimension with M microbatches in flight: stage 0 ingests a new microbatch
every tick, activations rotate stage -> stage+1 by point-to-point sends
(``batch_isend_irecv``), and the last stage emits a finished microbatch per
tick once the pipeline fills (total ticks = M + S - 1).

Stage partitioning is shared with the training simulator:
``partition_stages`` (from ``repro_torch.sim.ir``) is the single
balanced-split rule, and ``stage_layer_slices`` turns it into the
``[start, stop)`` layer ranges a stage owns — so the layer shares
``repro_torch.sim.training.simulate_training`` prices are exactly the
shares this module would execute.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist import context as dist_ctx
from repro_torch.sim.ir import partition_stages  # noqa: F401  (shared rule)


def stage_layer_slices(n_layers: int, n_stages: int
                       ) -> List[Tuple[int, int]]:
    """``[start, stop)`` layer range per pipeline stage under the balanced
    ``partition_stages`` split (first ``n_layers % n_stages`` stages carry
    one extra layer)."""
    out: List[Tuple[int, int]] = []
    start = 0
    for n in partition_stages(n_layers, n_stages):
        out.append((start, start + n))
        start += n
    return out


def pipeline_apply(mesh, stage_fn, stage_params, x, n_microbatches: int):
    """Apply ``stage_fn(w, x)`` for each of S pipeline stages.

    stage_params: this rank's own stage's params (the rank's coordinate on
    the mesh's ``stage`` dimension is its stage); x: (B, ...) the global
    batch, the same on every rank, B divisible by n_microbatches.  Returns,
    on every rank, stage_fn applied S times in sequence, computed
    pipelined: the last stage's drained outputs made whole by an
    ``all_reduce`` over ``stage`` of each rank's (zero elsewhere), as the
    reference's ``psum`` does.  With one stage the rotation is a local
    copy."""
    names = list(mesh.mesh_dim_names)
    n_stages = int(mesh.size(names.index("stage")))
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} does not split into {n_microbatches} "
                         f"microbatches")
    mb = B // n_microbatches
    xs = x.reshape(n_microbatches, mb, *x.shape[1:])
    stage = int(mesh.get_local_rank("stage"))
    group = mesh.get_group("stage") if n_stages > 1 else None
    if group is not None:
        nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
        prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    is_first, is_last = stage == 0, stage == n_stages - 1
    buf = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    with dist_ctx.bound_axes("stage"):
        for t in range(n_microbatches + n_stages - 1):
            # stage 0 ingests microbatch t; later stages consume the rotated
            # activation produced one tick earlier by their predecessor
            inp = xs[min(t, n_microbatches - 1)] if is_first else buf
            y = stage_fn(stage_params, inp)
            # the last stage drains microbatch t-(S-1) once the pipe is full
            j = t - (n_stages - 1)
            if is_last and j >= 0:
                outs[j] = y
            if group is None:
                buf = y
                continue
            buf = torch.empty_like(y)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                    dist.P2POp(dist.irecv, buf, prv, group)]):
                req.wait()
        # replicate the drained result (resident on the last stage) to all
        if group is not None:
            dist.all_reduce(outs, group=group)
    return outs.reshape(B, *x.shape[1:])
