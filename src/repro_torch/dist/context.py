"""Process-global distribution context: the active mesh, the axes bound by
a manual region, and the performance flags; the port's copy of the JAX
package's ``repro.dist.context``.

A launcher installs a mesh (a ``torch.distributed`` ``DeviceMesh`` whose
dimensions carry the reference's axis names: ``pod``, ``data``, ``model``,
``stage``) and a ``PerfFlags`` set; model code reads them through the
accessors here, so the same forward functions serve one device, a mesh and
every ablation without threading either through call signatures.  The
default is "no mesh, baseline flags", so single-device tests need no setup.

The port's distribution is manual SPMD, the counterpart of ``shard_map``:
each rank holds its local shard, and a collective runs over the sub-group
of a named mesh dimension.  A manual region (expert-parallel MoE, the
pipeline) binds its axes with ``bound_axes(...)``, as ``shard_map`` binds
them; ``tp.tp_project`` reduces only over a bound axis.
``bf16_tp_collectives`` acts on a mesh: it casts ``tp_project``'s
all-reduce to bf16 on the wire.  ``seq_sharded_residual`` is, in the
reference, a sharding constraint on the residual stream that GSPMD
propagates; its port needs parameters sharded as DTensors (ROADMAP Queue 1
item 10b), so it has no effect yet.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, fields
from typing import FrozenSet, Optional, Tuple, Union


@dataclass(frozen=True)
class PerfFlags:
    """Beyond-paper optimization switches (all default to baseline).

    attn_remat_chunk      checkpoint the online-softmax body per KV chunk
    windowed_attention    static sliding-window paths for local:global archs
    seq_sharded_residual  Megatron-SP residual stream (no effect yet: 10b)
    bf16_tp_collectives   bf16 TP collectives (acts only on a mesh)
    ssm_impl              'scan' (recurrent) | 'chunked' (SSD-style blocks)
    moe_dispatch          'gather' (index dispatch) | 'einsum' (one-hot)
    """
    attn_remat_chunk: bool = False
    windowed_attention: bool = False
    seq_sharded_residual: bool = False
    bf16_tp_collectives: bool = False
    ssm_impl: str = "scan"
    moe_dispatch: str = "gather"

    def __post_init__(self):
        # CLI override strings ("ssm_impl=chunked", bare flags -> True) come
        # through as str; normalize bool-typed fields.
        for f in fields(self):
            v = getattr(self, f.name)
            if f.type == "bool" and isinstance(v, str):
                object.__setattr__(
                    self, f.name, v.lower() in ("1", "true", "yes", "on"))


_STATE = {"mesh": None, "flags": PerfFlags(), "bound": frozenset(),
          "global_batch": None}


def set_mesh(mesh) -> None:
    """Install (or clear, with ``None``) the active device mesh."""
    _STATE["mesh"] = mesh


def get_mesh():
    return _STATE["mesh"]


def set_perf_flags(flags: PerfFlags) -> None:
    _STATE["flags"] = flags


def perf_flags() -> PerfFlags:
    return _STATE["flags"]


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (its ``mesh_dim_names``), or
    of any object whose ``shape`` is a dict (the reference tests' fake
    meshes); {} for None."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    try:
        return {k: int(v) for k, v in dict(mesh.shape).items()}
    except (TypeError, ValueError):
        return {}


def mesh_axis_size(name: str) -> int:
    """Size of a mesh axis; 1 when no mesh or the axis is absent."""
    return mesh_shape(_STATE["mesh"]).get(name, 1)


def dp_axes() -> Optional[Union[str, Tuple[str, ...]]]:
    """The data-parallel mesh axes (>1) in ('pod', 'data') order.

    Returns a bare name, a tuple, or None, as the reference's does: a
    ``PartitionSpec`` entry, or the axes a mean over data ranks takes."""
    axes = tuple(a for a in ("pod", "data") if mesh_axis_size(a) > 1)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def axis_names(axes) -> Tuple[str, ...]:
    """A spec entry (None, a name or a tuple of names) as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def bound() -> FrozenSet[str]:
    """The mesh axes bound by the manual regions around this call."""
    return _STATE["bound"]


@contextlib.contextmanager
def bound_axes(*names: str):
    """Bind ``names`` for the block: a manual region, where each rank holds
    its shard and collectives over these axes are the caller's to make."""
    before = _STATE["bound"]
    _STATE["bound"] = before | frozenset(names)
    try:
        yield
    finally:
        _STATE["bound"] = before


def global_batch_axes():
    """The spec entry set by ``global_batch`` around this call (None
    outside one)."""
    return _STATE["global_batch"]


@contextlib.contextmanager
def global_batch(axes):
    """Mark the model's batch, for the block, as this rank's shard of a
    global batch over the mesh dimensions ``axes`` (a spec entry; shards
    of equal size, in ``shard_of``'s order).  What the model computes over
    the batch as a whole, the MoE's expert capacity and routing statistics,
    is then computed over the global batch, as the reference's jit
    computes it on a batch sharded by the rules."""
    before = _STATE["global_batch"]
    _STATE["global_batch"] = axes
    try:
        yield
    finally:
        _STATE["global_batch"] = before


def axis_group(name: str, mesh=None):
    """The process group of the dimension ``name`` of ``mesh`` (by
    default the active one)."""
    return (mesh if mesh is not None else _STATE["mesh"]).get_group(name)


def axis_rank(name: str) -> int:
    """This rank's coordinate along the active mesh's dimension ``name``
    (0 when there is no such dimension)."""
    mesh = _STATE["mesh"]
    if mesh is None or name not in (getattr(mesh, "mesh_dim_names", None)
                                    or ()):
        return 0
    return int(mesh.get_local_rank(name))


def all_reduce(x, axes, op: str = "sum", mesh=None):
    """``x`` reduced in place over the dimensions ``axes`` (an entry: None,
    a name or a tuple) of ``mesh`` (by default the active one), one
    dimension of size > 1 after the other; ``op`` "sum" or "mean".  A
    dimension of size 1 is skipped, as the reference's collectives skip
    it; any other needs a process group."""
    import torch.distributed as dist
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    shape = mesh_shape(mesh if mesh is not None else _STATE["mesh"])
    n = 1
    for name in axis_names(axes):
        size = shape.get(name, 1)
        if size > 1:
            dist.all_reduce(x, group=axis_group(name, mesh))
            n *= size
    if op == "mean" and n > 1:
        x.div_(n)
    return x


def shard_of(axes) -> Tuple[int, int]:
    """(index, count) of this rank's shard along a spec entry's mesh
    dimensions, the first the most major, as JAX orders a tuple entry."""
    index, count = 0, 1
    for name in axis_names(axes):
        size = mesh_axis_size(name)
        index, count = index * size + axis_rank(name), count * size
    return index, count
