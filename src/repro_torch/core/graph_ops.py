"""Graph-node executors on torch tensors, NHWC throughout.

Convolutions lower to im2col matmuls: the NVDLA channel-reduction dataflow
(paper §II), with K ordered (kh, kw, cin) so that the HWIO weight reshaped
to (kh·kw·cin, cout) lines up.  Every convolution and matmul node goes
through ``repro_torch.kernels.ops.matmul``: on the card the hand-written
NVDLA matmul kernel, on the CPU its plain version.  The other nodes are
plain torch, as the reference computes them with jnp outside any Pallas
kernel.  Counterpart of the JAX package's ``repro/core/graph_ops.py``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def _activation(kind, x):
    if kind == "relu":
        return torch.relu(x)
    if kind == "gelu":          # jax.nn.gelu's default: the tanh form
        return F.gelu(x, approximate="tanh")
    return x


def _same_pads(size, k, stride):
    """(lo, hi) of ``lax.conv_general_dilated``'s "SAME": the output has
    ceil(size / stride) rows, and the odd one of the total pad goes high
    (a 2x2 kernel at stride 1 pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def im2col(x, kh, kw, stride, padding):
    """x (N, H, W, C) -> the patches of a (kh, kw) convolution at ``stride``
    with "same" or "valid" ``padding``, as (N·OH·OW, kh·kw·C) in (kh, kw,
    C) order, and the output's (N, OH, OW)."""
    if padding.lower() == "same":
        (t, b), (l, r) = (_same_pads(x.shape[1], kh, stride),
                          _same_pads(x.shape[2], kw, stride))
        x = F.pad(x, (0, 0, l, r, t, b))
    # (N, OH, OW, C, kh, kw): windows as views, then one copy in K order
    p = x.unfold(1, kh, stride).unfold(2, kw, stride)
    n, oh, ow = p.shape[:3]
    return p.permute(0, 1, 2, 4, 5, 3).reshape(n * oh * ow, -1), (n, oh, ow)


def matmul_operands(n, vals):
    """The (a, b) of a convolution or matmul node's product, from the values
    of its inputs, and the shape its (M, N) result is seen as."""
    x, w = vals[n.inputs[0]], vals[n.inputs[1]]
    if n.op == "convolution":
        kh, kw, cin, cout = w.shape
        a, (nb, oh, ow) = im2col(x, kh, kw, n.attrs.get("stride", 1),
                                 n.attrs.get("padding", "same"))
        return a, w.reshape(kh * kw * cin, cout), (nb, oh, ow, cout)
    a = x.reshape(x.shape[0], -1) if x.dim() > 2 else x
    return a, w, (a.shape[0], w.shape[1])


def product_shape(g, n):
    """(M, N, K) of a convolution or matmul node's product, from the
    graph's static shapes: ``matmul_operands``' (a, b) are (M, K), (K, N)."""
    w = g.nodes[n.inputs[1]].shape
    if n.op == "convolution":
        return math.prod(n.shape[:3]), w[3], w[0] * w[1] * w[2]
    x = g.nodes[n.inputs[0]].shape
    return x[0], w[1], math.prod(x[1:])


def run_node(g, n, vals: Dict, fused_into: Dict[str, str]):
    x = vals[n.inputs[0]] if n.inputs else None
    if n.op in ("convolution", "matmul"):
        a, b, shape = matmul_operands(n, vals)
        out = _activation(n.attrs.get("activation"),
                          ops.matmul(a, b).reshape(shape))
    elif n.op == "add":
        out = _activation(n.attrs.get("activation"),
                          x + vals[n.inputs[1]])
    elif n.op == "relu":
        out = torch.relu(x)
    elif n.op == "max_pool":    # VALID, window = stride = k
        k = n.attrs.get("k", 2)
        nb, h, w, c = x.shape
        out = x[:, :h // k * k, :w // k * k] \
            .reshape(nb, h // k, k, w // k, k, c).amax((2, 4))
    elif n.op == "batch_norm":  # batch statistics, as the reference
        scale = g.param(n.name + "_scale", x.device)
        bias = g.param(n.name + "_bias", x.device)
        var, mu = torch.var_mean(x, (0, 1, 2), correction=0, keepdim=True)
        out = (x - mu) * torch.rsqrt(var + 1e-5) * scale + bias
    elif n.op == "flatten":
        out = x.reshape(n.shape)
    else:
        raise ValueError(f"unknown op {n.op}")
    # apply any elementwise op fused into this node
    for consumer, producer in fused_into.items():
        if producer == n.name:
            cn = g.nodes[consumer]
            if cn.op in ("relu", "gelu"):
                out = _activation(cn.op, out)
            vals[consumer] = out
    return out
