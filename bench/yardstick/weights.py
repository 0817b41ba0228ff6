"""Random weights from the seed, made on the device in a few large calls,
in the types they are served in, in the program's param tree.

The leaves of one block are the family's (``block_leaves`` of
``reference/<family>.py``, beside the reference that reads them); the
embedding, the final norm and the untied head are every family's.  Each
matrix is drawn from a normal at the scale the program's own init gives
it (1 / sqrt(fan-in); the embedding 0.02), so that activations stay
finite through the whole depth; constants are the program's too.
Matrices of one scale and type are views of one buffer drawn by one call,
so a model costs a handful of calls.  The same tensors go to the program
and to the reference; neither writes them.
"""
from __future__ import annotations

import importlib
import math
from typing import Dict, List, Tuple

import torch

BF16 = torch.bfloat16
F32 = torch.float32


def leaves(spec) -> List[Tuple[str, tuple, torch.dtype, tuple]]:
    """Every leaf of the param tree, as ``tree.flatten`` names them: (path,
    shape, dtype, init), init ("normal", scale), ("fill", value) or
    ("log_range",) (log 1 .. n along the last dimension, every row)."""
    m = spec["model"]
    d, V = m["d_model"], m["vocab"]
    block = importlib.import_module(
        f"reference.{spec['reference']}").block_leaves(spec)
    out = [("embed", (V, d), BF16, ("normal", 0.02))]
    for i in range(m["n_layers"]):
        out += [(f"layers/{i}/{p}", *rest) for p, *rest in block]
    out.append(("final_norm", (d,), F32, ("fill", 1.0)))
    if not m.get("tie_embeddings", False):
        out.append(("lm_head", (d, V), BF16, ("normal", d ** -0.5)))
    return out


def _const(init, shape, dtype, device):
    if init[0] == "fill":
        return torch.full(shape, init[1], dtype=dtype, device=device)
    if init[0] == "log_range":
        n = shape[-1]
        row = torch.log(torch.arange(1, n + 1, dtype=dtype, device=device))
        return row.expand(shape).contiguous()
    raise ValueError(f"unknown init {init!r}")


def make(spec, seed: int, device) -> Dict:
    """The param tree of the configuration ``spec``, drawn from ``seed`` by
    a generator on ``device``: one normal draw for each (scale, type)
    group, in a fixed order, then views."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    todo = leaves(spec)
    groups: Dict[tuple, int] = {}
    for _, shape, dtype, init in todo:
        if init[0] == "normal":
            key = (init[1], dtype)
            groups[key] = groups.get(key, 0) + math.prod(shape)
    buffers, offsets = {}, {}
    for key in sorted(groups, key=lambda k: (str(k[1]), k[0])):
        buf = torch.randn(groups[key], generator=gen, device=device,
                          dtype=key[1])
        buffers[key] = buf.mul_(key[0])
        offsets[key] = 0
    consts, flat = {}, {}
    for path, shape, dtype, init in todo:
        if init[0] == "normal":
            key = (init[1], dtype)
            n, at = math.prod(shape), offsets[key]
            flat[path] = buffers[key][at:at + n].view(shape)
            offsets[key] = at + n
        else:
            ck = (init, shape, dtype)
            if ck not in consts:
                consts[ck] = _const(init, shape, dtype, device)
            flat[path] = consts[ck]
    return unflatten(flat)


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    """The nested tree of ``{path: leaf}``: ``layers`` a list of blocks."""
    tree: Dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    tree["layers"] = [tree["layers"][str(i)]
                      for i in range(len(tree["layers"]))]
    return tree
