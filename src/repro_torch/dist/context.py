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
pipeline, the train step over a ``model`` axis) binds its axes with
``bound_axes(...)``, as ``shard_map`` binds them.  Under autograd the
collectives are the Megatron pairs, each a ``torch.autograd.Function``:
``copy_to`` (identity forward, all-reduce backward), ``reduce_from``
(all-reduce forward, identity backward), ``summed`` (all-reduce both
ways), ``gather_from`` (all-gather forward, this rank's slice backward;
with ``reduce_grad`` the gradient is summed first, a reduce-scatter) and
``scatter_to`` and ``reduce_scatter_to`` for the sequence-sharded
residual.  ``all_reduce`` stays for the
non-differentiable uses.  A collective over an axis of size 1 is skipped.

``bf16_tp_collectives`` casts a tensor-parallel region's closing reduction
to bf16 on the wire.  ``seq_sharded_residual`` is, in the reference, a
sharding constraint on the residual stream that GSPMD propagates; in the
port's train step over a ``model`` axis it keeps the residual stream
sharded on the sequence over ``model`` between blocks
(``models.transformer._backbone``, ``dist.tp.enter``/``leave``): a region's
entry all-gathers the sequence and its exit reduce-scatters it.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, fields
from typing import FrozenSet, Optional, Tuple, Union

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class PerfFlags:
    """Beyond-paper optimization switches (all default to baseline).

    attn_remat_chunk      checkpoint the online-softmax body per KV chunk
    windowed_attention    static sliding-window paths for local:global archs
    seq_sharded_residual  Megatron-SP residual stream (the step over 'model')
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
          "global_batch": None, "seq_sharded": False}


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


def seq_sharded() -> bool:
    """Whether the residual stream is sharded on the sequence over
    ``model`` around this call (``seq_sharded_region``)."""
    return _STATE["seq_sharded"]


@contextlib.contextmanager
def seq_sharded_region(on: bool = True):
    """For the block, the residual stream is (with ``on``) this rank's
    shard of the sequence over ``model``: a tensor-parallel region's entry
    gathers it and its exit reduce-scatters (``dist.tp``)."""
    before = _STATE["seq_sharded"]
    _STATE["seq_sharded"] = on
    try:
        yield
    finally:
        _STATE["seq_sharded"] = before


def snapshot() -> dict:
    """The context as it stands (mesh, flags, bound axes, global batch,
    sequence sharding), for ``restored``."""
    return dict(_STATE)


@contextlib.contextmanager
def restored(state: dict):
    """``state`` (a ``snapshot``) in force for the block: what an
    activation checkpoint's recompute runs under, since the backward runs
    it outside the forward's ``with`` blocks."""
    before = dict(_STATE)
    _STATE.update(state)
    try:
        yield
    finally:
        _STATE.update(before)


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
    dimension of size > 1 after the other; ``op`` "sum", "mean" or "max".
    A dimension of size 1 is skipped, as the reference's collectives skip
    it; any other needs a process group."""
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"op must be 'sum', 'mean' or 'max', got {op!r}")
    reduce_op = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    shape = mesh_shape(mesh if mesh is not None else _STATE["mesh"])
    n = 1
    for name in axis_names(axes):
        size = shape.get(name, 1)
        if size > 1:
            dist.all_reduce(x, op=reduce_op, group=axis_group(name, mesh))
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


def model_size() -> int:
    """The size of the active mesh's ``model`` axis (1 off a mesh)."""
    return mesh_axis_size("model")


def model_rank() -> int:
    """This rank's coordinate on the ``model`` axis (0 off a mesh)."""
    return axis_rank("model")


# ---------------------------------------------------------------------------
# differentiable collectives over one mesh axis (the Megatron pairs)


def _all_gather(x, axis: str, dim: int):
    """The shards ``x`` of the ranks of ``axis`` concatenated along
    ``dim``, in rank order.  gloo has it for CUDA tensors too (torch 2.11),
    staged through the host, as its all-reduce is."""
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((mesh_axis_size(axis) * x0.shape[0], *x0.shape[1:]))
    dist.all_gather_into_tensor(out, x0, group=axis_group(axis))
    return out.movedim(0, dim)


def _reduce_scatter(x, axis: str, dim: int):
    """``x`` summed over the ranks of ``axis``, each keeping its 1/n slice
    along ``dim``."""
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((x0.shape[0] // mesh_axis_size(axis),
                        *x0.shape[1:]))
    dist.reduce_scatter_tensor(out, x0, group=axis_group(axis))
    return out.movedim(0, dim).contiguous()


def rank_slice(x, axis: str, dim: int):
    """This rank's contiguous 1/n of ``x`` along ``dim``, n the size of the
    mesh axis ``axis``."""
    n, r = mesh_axis_size(axis), axis_rank(axis)
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k).contiguous()


def _summed(x, axes, wire=None):
    """A contiguous copy of ``x`` all-reduced over ``axes`` (in ``wire``'s
    dtype on the wire when given)."""
    out = x.to(wire or x.dtype, memory_format=torch.contiguous_format,
               copy=True)
    all_reduce(out, axes)
    return out.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, wire):
        return _summed(x, axis, wire)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Summed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _summed(x, axes)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.axes), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, reduce_grad):
        ctx.args = (axis, dim, reduce_grad)
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim, reduce_grad = ctx.args
        if reduce_grad:
            return _reduce_scatter(g, axis, dim), None, None, None
        return rank_slice(g, axis, dim), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.args = (axis, dim)
        return rank_slice(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None


class _ReduceScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.args = (axis, dim)
        return _reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None


def copy_to(x, axis: str = "model"):
    """``x`` entering a region whose ranks of ``axis`` each compute a part
    from it: the identity forward; backward, the ranks' gradients summed
    (all-reduce)."""
    if mesh_axis_size(axis) <= 1:
        return x
    return _CopyTo.apply(x, axis)


def reduce_from(x, axis: str = "model", wire=None):
    """The partial sums ``x`` of the ranks of ``axis`` summed (all-reduce;
    in ``wire``'s dtype on the wire when given); backward, the identity."""
    if mesh_axis_size(axis) <= 1:
        return x
    return _ReduceFrom.apply(x, axis, wire)


def summed(x, axes):
    """``x`` summed over the mesh axes ``axes`` (a spec entry), forward and
    backward: a term each rank computes a part of and then uses whole for
    its own part (Mamba1's ``x_proj`` over ``model``, the MoE's routing
    statistics over the data axes), so that its gradient is the ranks'
    summed."""
    return _Summed.apply(x, axes)


def gather_from(x, axis: str = "model", dim: int = -1,
                reduce_grad: bool = False):
    """The shards ``x`` of the ranks of ``axis`` concatenated along ``dim``
    (all-gather); backward, this rank's slice of the gradient, summed over
    the ranks first with ``reduce_grad`` (a reduce-scatter: where the ranks
    use different parts of the whole, as a weight gathered at use or a
    sequence entering a sharded region)."""
    if mesh_axis_size(axis) <= 1:
        return x
    return _GatherFrom.apply(x, axis, dim % x.dim(), reduce_grad)


def scatter_to(x, axis: str = "model", dim: int = -1):
    """This rank's 1/n slice of ``x`` along ``dim``, the reverse of
    ``gather_from``; backward, the slices' gradients all-gathered."""
    if mesh_axis_size(axis) <= 1:
        return x
    return _ScatterTo.apply(x, axis, dim % x.dim())


def reduce_scatter_to(x, axis: str = "model", dim: int = -1):
    """The partial sums ``x`` summed over the ranks of ``axis``, each
    keeping its 1/n slice along ``dim`` (reduce-scatter); backward, the
    slices' gradients all-gathered."""
    if mesh_axis_size(axis) <= 1:
        return x
    return _ReduceScatterTo.apply(x, axis, dim % x.dim())
