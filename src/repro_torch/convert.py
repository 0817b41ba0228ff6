"""Carry the JAX package's parameters across to the port.

The input is the reference's params as a nested dict of numpy arrays, its
layers stacked along a leading axis, with bf16 leaves given as float32
(numpy has no bf16 type that torch takes).  The leaves that are float32 in
the reference stay float32 (``FLOAT32_KEYS``: the norm scales, whisper's
cross-attention norm ``norm_x``, MLA's ``kv_norm`` and Mamba2's gate
``norm`` among them; Mamba1's and Mamba2's
``A_log``, ``D`` and ``dt_bias``, where A_log = log(1..N) is not exact in
bf16; and the MoE ``router``, whose
float32 logits pick each token's experts: rounded to bf16 they would move
assignments across the top-k edge); every other leaf is cast back to bf16,
which undoes that widening exactly.
Dense weights keep the reference's ``(in, out)`` layout, since the port
applies them as ``x @ w``: no transpose is needed.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

FLOAT32_KEYS = frozenset({"norm1", "norm2", "norm_x", "final_norm",
                          "kv_norm", "norm", "A_log", "D", "dt_bias",
                          "router"})


def _leaf(name, a, device):
    dtype = torch.float32 if name in FLOAT32_KEYS else torch.bfloat16
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device, dtype)


def _tree(d, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(k, v)
            for k, v in d.items()}


def tree_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """One block's params, or any subtree of them (an attention or MLP
    dict), from the reference's nested dict of numpy arrays."""
    return _tree(tree, lambda k, a: _leaf(k, a, device))


def _unstack(layers, device):
    """A stack of blocks (each leaf with a leading layer axis) as a list of
    per-block dicts."""
    return [tree_from_jax(_tree(layers, lambda k, a, i=i: a[i]), device)
            for i in range(len(layers["norm1"]))]


def params_from_jax(params: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The port's params (``layers``, and the encdec family's
    ``encoder["layers"]``, as lists of per-block dicts) from the
    reference's nested dict of numpy arrays."""
    stacks = ("layers", "encoder")
    out = tree_from_jax({k: v for k, v in params.items() if k not in stacks},
                        device)
    out["layers"] = _unstack(params["layers"], device)
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"layers": _unstack(enc["layers"], device),
                          **tree_from_jax({k: v for k, v in enc.items()
                                           if k != "layers"}, device)}
    return out


def to_device(tree, device):
    """A copy of a params tree (dicts and lists of tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)
