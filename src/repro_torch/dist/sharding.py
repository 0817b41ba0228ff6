"""Logical-axis sharding rule engine: the port's copy of the JAX package's
``repro.dist.sharding``.

Parameters and activations carry *logical* axis names (``"d_ff"``,
``"heads_x_dim"``, ``"kv_seq"``...); a ``Rules`` table maps each logical axis
to a mesh axis (or a tuple of mesh axes, or None).  ``spec_for`` applies the
table with the safety guards that make the whole (arch x shape x mesh) sweep
lowerable:

  * a mesh axis of size 1 never shards anything,
  * a dimension is only sharded when its size is divisible by the mesh-axis
    product,
  * a mesh axis is used at most once per spec (first logical axis wins),
  * a spec with nothing sharded collapses to the replicated ``P()``.

``rules_for`` derives the per-cell table: data-parallel batch sharding when
the batch divides, sequence-parallel fallback when it cannot (long-context
decode), TP over heads with the MQA head_dim fallback, and expert/FFN
sharding over 'model'.

A spec is the port's own ``PartitionSpec``, a tuple of entries equal to
the reference's entry for entry.  ``tree_shardings`` turns each spec into
``DTensor`` placements over the mesh's dimensions (``Shard(dim)`` or
``Replicate()`` for each), what ``distribute_tensor`` takes.  An axes tree
is the params' (or cache's) structure with a tuple of logical names at each
leaf (``models.transformer.param_axes`` / ``cache_axes``).

The train step over a ``model`` axis holds params and AdamW's moments as
``DTensor``s with those placements (``distribute``; ``ckpt.load_checkpoint``
restores them so) and computes on their local shards (``local_shards``,
each marked with the dimension it is split along over ``model``:
``dist.tp.mark_shard``), updating them in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.config import ModelConfig, ShapeConfig
from repro_torch.dist.context import axis_names, mesh_shape

Entry = Union[str, Tuple[str, ...], None]


class PartitionSpec(tuple):
    """One entry a tensor dimension: None (replicated), a mesh axis name,
    or a tuple of names (sharded over their product, the first the most
    major).  ``P()`` is replicated."""

    def __new__(cls, *entries: Entry):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _axes_leaf(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x))


def map_axes(fn, axes_tree, *trees):
    """A tree of ``axes_tree``'s structure (dicts and lists) with
    ``fn(axes, *leaves)`` at each axes leaf, ``trees`` walked alongside."""
    if _axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees))
                for k, v in axes_tree.items()}
    return [map_axes(fn, v, *(t[i] for t in trees))
            for i, v in enumerate(axes_tree)]


@dataclass
class Rules:
    table: Dict[str, Entry]
    mesh: Any = None

    # -- spec construction ---------------------------------------------------
    def spec_for(self, axes: Sequence[Optional[str]],
                 shape: Sequence[int]) -> PartitionSpec:
        """PartitionSpec for a tensor with the given logical axes."""
        ms = mesh_shape(self.mesh)
        used: set = set()
        entries = []
        sharded = False
        for i, ax in enumerate(axes):
            entry = self.table.get(ax) if ax is not None else None
            if entry is None:
                entries.append(None)
                continue
            names = axis_names(entry)
            size = math.prod(ms.get(n, 1) for n in names)
            dim = shape[i] if i < len(shape) else 0
            if size <= 1 or any(n in used for n in names) \
                    or dim % size != 0:
                entries.append(None)
                continue
            used.update(names)
            entries.append(entry)
            sharded = True
        if not sharded:
            return P()
        return P(*entries)

    def placements(self, spec: PartitionSpec) -> Tuple[Any, ...]:
        """``DTensor`` placements of ``spec`` over the mesh's dimensions in
        their order, a tuple: ``Shard(i)`` where tensor dimension i is
        sharded over that mesh dimension, else ``Replicate()``.  A tuple
        entry must name its mesh dimensions in the mesh's order, the major
        one first."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(mesh_shape(self.mesh))
        out: List[Any] = [Replicate()] * len(names)
        for i, entry in enumerate(spec):
            dims = [names.index(n) for n in axis_names(entry)]
            if dims != sorted(dims):
                raise ValueError(f"{spec}: {entry} is not in the mesh's "
                                 f"order {names}")
            for d in dims:
                out[d] = Shard(i)
        return tuple(out)

    def tree_shardings(self, axes_tree, value_tree):
        """Placements for every leaf of ``value_tree`` (a tree of tensors,
        or of anything with a ``shape``) whose ``axes_tree`` leaf is a
        tuple of logical names (or None)."""
        return map_axes(
            lambda a, v: self.placements(self.spec_for(a or (),
                                                       tuple(v.shape))),
            axes_tree, value_tree)


# ---------------------------------------------------------------------------
# rule derivation


def default_rules(mesh) -> Rules:
    """Generic table: DP batch, TP everything wide, no sequence parallelism."""
    ms = mesh_shape(mesh)
    dp = tuple(a for a in ("pod", "data") if ms.get(a, 1) > 1)
    batch: Entry = dp if len(dp) > 1 else (dp[0] if dp else None)
    return Rules(table={
        "batch": batch,
        "vocab": "model",
        "d_model": None,
        "d_ff": "model",
        "d_inner": "model",
        "heads_x_dim": "model",
        "kv_heads_x_dim": "model",
        "kv_heads": "model",
        "head_dim": None,
        "experts": "model",
        "kv_seq": None,
        "seq_model": "model",
        "layers": None,
        "kv_lora": None,
        "ssm_heads": None,
    }, mesh=mesh)


def rules_for(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Rules:
    """Per-cell rule table (divisibility-guarded; see module docstring)."""
    ms = mesh_shape(mesh)
    model = ms.get("model", 1)
    data = ms.get("data", 1)
    dp_names = tuple(a for a in ("pod", "data") if ms.get(a, 1) > 1)
    dp = math.prod(ms.get(a, 1) for a in dp_names) if dp_names else 1
    B, S = shape.global_batch, shape.seq_len
    hd = cfg.resolved_head_dim

    table: Dict[str, Entry] = {
        "d_model": None, "layers": None, "kv_lora": None, "ssm_heads": None,
    }

    # batch: DP when it divides; otherwise replicated and SP takes over
    if dp_names and dp > 1 and B % dp == 0:
        table["batch"] = dp_names if len(dp_names) > 1 else dp_names[0]
    else:
        table["batch"] = None

    # sequence parallelism over 'data' when the batch could not use it
    # (single-sequence long-context decode — the KV cache is the big tensor)
    if table["batch"] is None and data > 1 and S % data == 0:
        table["kv_seq"] = "data"
    else:
        table["kv_seq"] = None

    # tensor parallelism over 'model'
    def tp(n: int) -> Entry:
        return "model" if model > 1 and n % model == 0 else None

    table["heads_x_dim"] = tp(cfg.n_heads)
    table["kv_heads_x_dim"] = tp(cfg.n_kv_heads)
    table["kv_heads"] = table["kv_heads_x_dim"]
    # MQA/GQA fallback: too few KV heads for the model axis -> shard the
    # head_dim of the cache instead so long-context decode still distributes
    table["head_dim"] = tp(hd) if table["kv_heads"] is None else None
    table["d_ff"] = tp(cfg.d_ff)
    table["vocab"] = tp(cfg.vocab)
    table["seq_model"] = "model" if model > 1 and S % model == 0 else None
    if cfg.ssm is not None:
        table["d_inner"] = tp(cfg.ssm.expand * cfg.d_model)
    else:
        table["d_inner"] = None
    if cfg.moe is not None:
        table["experts"] = tp(cfg.moe.n_experts)
    else:
        table["experts"] = None
    return Rules(table=table, mesh=mesh)


# ---------------------------------------------------------------------------
# active-rules global (installed by the launchers, read by ``constrain``)

_ACTIVE: Dict[str, Optional[Rules]] = {"rules": None}


def set_active_rules(rules: Optional[Rules]) -> None:
    _ACTIVE["rules"] = rules


def active_rules() -> Optional[Rules]:
    return _ACTIVE["rules"]


def constrain(x, axes: Sequence[Optional[str]]):
    """Sharding-constrain ``x`` per the active rules; identity when no rules
    or no real mesh are installed (single-device tests).  A ``DTensor`` is
    redistributed to the spec; a local tensor (a rank's shard in a manual
    region) passes through, as ``with_sharding_constraint`` is numerically
    the identity."""
    rules = _ACTIVE["rules"]
    if rules is None or rules.mesh is None \
            or not hasattr(rules.mesh, "mesh_dim_names"):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = rules.spec_for(axes, x.shape)
    return x.redistribute(rules.mesh, rules.placements(spec))


# ---------------------------------------------------------------------------
# DTensors and their local shards


def sharded_dim(placements, axis: str, mesh=None) -> Optional[int]:
    """The tensor dimension that ``placements`` (a ``DTensor``'s, one a
    mesh dimension) shard over the mesh dimension ``axis`` of ``mesh`` (by
    default the active one), or None where they replicate over it."""
    from repro_torch.dist.context import get_mesh
    names = list(mesh_shape(mesh if mesh is not None else get_mesh()))
    if axis not in names or placements is None:
        return None
    p = placements[names.index(axis)]
    return p.dim if p.is_shard() else None


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def distribute(tree_, shardings, mesh):
    """Each leaf of ``tree_`` (full values, the same on every rank) as a
    ``DTensor`` on ``mesh`` with its placements from ``shardings``
    (``Rules.tree_shardings``): every rank keeps only its shard, cut from
    its own copy without communication, in storage of its own (a shard
    along dim 0 would be a view that keeps the whole leaf alive, a
    replicated leaf the input itself, which the step would update)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.core import tree
    flat = tree.flatten(tree_)
    for k, placements in tree.flatten(shardings, containers=list).items():
        t = distribute_tensor(flat[k], mesh, placements, src_data_rank=None)
        local = t.to_local()
        if not _is_fake(local) and local.untyped_storage().data_ptr() == \
                flat[k].untyped_storage().data_ptr():
            t = DTensor.from_local(local.clone(), mesh, placements,
                                   run_check=False, shape=t.shape,
                                   stride=t.stride())
        flat[k] = t
    return tree.unflatten(tree_, flat)


def _is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor (the dry run's), which owns no
    storage to compare."""
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def local_shards(tree_):
    """``tree_`` with each ``DTensor`` leaf replaced by its local shard (the
    same storage: an in-place update of the shard updates the DTensor),
    marked with the dimension it is split along over ``model``
    (``tp.mark_shard``; None where it is replicated there).  Other leaves
    pass through."""
    import torch
    from repro_torch.core import tree
    from repro_torch.dist.tp import mark_shard

    def leaf(t):
        if not is_dtensor(t):
            return t
        with torch.no_grad():
            local = t.to_local()
        return mark_shard(local, sharded_dim(t.placements, "model",
                                             t.device_mesh))
    return tree.map_tree(leaf, tree_)

