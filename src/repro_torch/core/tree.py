"""The port's param and state trees: nested dicts and lists of tensors.

The JAX package walks its trees with ``jax.tree_util``; the port's are
plain containers, walked here in a fixed order (dict keys as inserted,
list items by index).  A leaf's key is its path joined by ``/``, as the
reference's checkpoints name leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List


def flatten(tree, prefix: str = "", containers=(list, tuple)
            ) -> Dict[str, Any]:
    """{path: leaf} of every leaf of ``tree``, in tree order.  Dicts and
    the sequence types ``containers`` are walked; anything else is a
    leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, containers):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k),
                           containers))
    return out


def leaves(tree) -> List[Any]:
    """Every leaf of ``tree``, in tree order."""
    return list(flatten(tree).values())


def map_tree(fn: Callable, tree):
    """A tree of ``tree``'s structure with ``fn(leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def unflatten(template, flat: Dict[str, Any], prefix: str = ""):
    """A tree of ``template``'s structure whose leaves are ``flat``'s
    entries under the same paths."""
    if isinstance(template, dict):
        return {k: unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            unflatten(v, flat, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return flat[prefix]
