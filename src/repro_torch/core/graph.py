"""Declarative Python graph frontend (paper §II-A, Fig 2), run on torch.

Networks are built inside a ``Graph`` context with deferred execution,
serialized (topology JSON + parameters npz, the schema of the JAX package's
``repro/core/graph.py``, so that each package reads the other's files), then
executed in topological order with the operator-fusion pass.  On the card,
every convolution (as im2col) and every matmul node runs on the hand-written
NVDLA matmul kernel (``repro_torch.core.graph_ops``).

Example (the paper's residual unit):

    with Graph(name="residual", backend="mxu") as g:
        act = input_data("input", np.random.rand(1, 32, 32, 8))
        f0 = weight("f0", np.random.rand(3, 3, 8, 64))
        x = convolution("conv0", act, f0, stride=1, padding="same",
                        activation="relu")
        ...
        add("add", x, act, activation="relu")
    g.write_graph("residual")

The simulator views of the reference (``program()``, ``tile_tasks()``) are
not ported yet (ROADMAP Queue 1, pricing with the measured H100 table).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device

_CURRENT: List["Graph"] = []


@dataclass
class Node:
    name: str
    op: str
    inputs: List[str]
    attrs: Dict = field(default_factory=dict)
    shape: Tuple[int, ...] = ()


class GraphTensor:
    def __init__(self, name: str, shape, graph: "Graph"):
        self.name = name
        self.shape = tuple(shape)
        self.graph = graph


class Graph:
    def __init__(self, name: str, backend: str = "mxu"):
        self.name = name
        self.backend = backend
        self.nodes: Dict[str, Node] = {}
        self.order: List[str] = []
        self.params: Dict[str, np.ndarray] = {}
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        # device -> {param name: (the array it was copied from, tensor)}
        self._on_device: Dict[torch.device, Dict] = {}

    # -- context manager ----------------------------------------------------
    def __enter__(self):
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.pop()
        # outputs = nodes nobody consumes
        consumed = {i for n in self.nodes.values() for i in n.inputs}
        self.outputs = [n for n in self.order if n not in consumed]
        return False

    def add_node(self, node: Node) -> GraphTensor:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name}")
        self.nodes[node.name] = node
        self.order.append(node.name)
        return GraphTensor(node.name, node.shape, self)

    # -- serialization ------------------------------------------------------
    def write_graph(self, path: str):
        p = Path(path)
        topo = {"name": self.name, "backend": self.backend,
                "inputs": self.inputs, "outputs": self.outputs,
                "nodes": [{"name": n.name, "op": n.op, "inputs": n.inputs,
                           "attrs": n.attrs, "shape": list(n.shape)}
                          for n in (self.nodes[k] for k in self.order)]}
        p.with_suffix(".json").write_text(json.dumps(topo, indent=1))
        # parameters stored separately so they can be swapped (paper §II-A)
        np.savez(p.with_suffix(".npz"), **self.params)
        return p

    @classmethod
    def read_graph(cls, path: str) -> "Graph":
        p = Path(path)
        topo = json.loads(p.with_suffix(".json").read_text())
        g = cls(topo["name"], topo["backend"])
        for nd in topo["nodes"]:
            g.add_node(Node(nd["name"], nd["op"], nd["inputs"], nd["attrs"],
                            tuple(nd["shape"])))
        g.inputs = topo["inputs"]
        g.outputs = topo["outputs"]
        if p.with_suffix(".npz").exists():
            g.params = dict(np.load(p.with_suffix(".npz")))
        return g

    # -- execution ----------------------------------------------------------
    def param(self, name: str, device: torch.device) -> torch.Tensor:
        """``params[name]`` as a float32 tensor on ``device``, copied there at
        its first use and again only when ``params[name]`` is replaced."""
        cache = self._on_device.setdefault(device, {})
        arr = self.params[name]
        if name not in cache or cache[name][0] is not arr:
            cache[name] = (arr, torch.as_tensor(
                np.asarray(arr, np.float32)).to(device))
        return cache[name][1]

    def values(self, feeds: Dict, fuse: bool = True,
               device="cuda") -> Dict[str, torch.Tensor]:
        """Every node's value (inputs, weights and fused consumers included)
        from one topological run on ``device``; see :meth:`execute`."""
        from repro_torch.core import graph_ops as ops
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        vals: Dict[str, torch.Tensor] = {}
        fused_into: Dict[str, str] = self.fusion_plan() if fuse else {}
        for name in self.order:
            n = self.nodes[name]
            if n.op == "input":
                feed = feeds[name]
                if not isinstance(feed, torch.Tensor):   # as jnp.asarray
                    feed = torch.as_tensor(np.asarray(feed, np.float32))
                vals[name] = feed.to(device, torch.float32)
                continue
            if n.op == "weight":
                vals[name] = self.param(name, device)
                continue
            if name in fused_into:      # consumed by its fused producer
                continue
            vals[name] = ops.run_node(self, n, vals, fused_into)
        return vals

    def execute(self, feeds: Dict, fuse: bool = True,
                device="cuda") -> Dict[str, torch.Tensor]:
        """Topological execution with the automatic fusion pass, on the card
        unless ``device="cpu"``.  Feeds are numpy arrays (cast to float32, as
        ``jnp.asarray`` does with x64 off) or tensors; params go to the
        device once.  Returns the graph outputs as float32 tensors."""
        vals = self.values(feeds, fuse, device)
        return {o: vals[o] for o in self.outputs if o in vals}

    def fusion_plan(self) -> Dict[str, str]:
        """conv/matmul + following elementwise (relu/gelu) fusion: maps
        fused-consumer name -> producer it is folded into."""
        plan: Dict[str, str] = {}
        consumers: Dict[str, List[str]] = {}
        for n in self.nodes.values():
            for i in n.inputs:
                consumers.setdefault(i, []).append(n.name)
        for n in self.nodes.values():
            if n.op in ("convolution", "matmul") and \
                    not n.attrs.get("activation"):
                cons = consumers.get(n.name, [])
                if len(cons) == 1:
                    c = self.nodes[cons[0]]
                    if c.op in ("relu", "gelu"):
                        plan[c.name] = n.name
        return plan


def current_graph() -> Graph:
    if not _CURRENT:
        raise RuntimeError("no active Graph context")
    return _CURRENT[-1]


# ---------------------------------------------------------------------------
# builder API (paper Fig 2 style)


def input_data(name: str, array) -> GraphTensor:
    g = current_graph()
    arr = np.asarray(array)
    g.inputs.append(name)
    return g.add_node(Node(name, "input", [], {}, arr.shape))


def weight(name: str, array) -> GraphTensor:
    g = current_graph()
    arr = np.asarray(array, dtype=np.float32)
    g.params[name] = arr
    return g.add_node(Node(name, "weight", [], {}, arr.shape))


def convolution(name, x: GraphTensor, w: GraphTensor, *, stride=1,
                padding="same", activation=None) -> GraphTensor:
    g = current_graph()
    kh, kw, cin, cout = w.shape
    n, h, ww_, c = x.shape
    if padding == "same":
        oh, ow = (h + stride - 1) // stride, (ww_ + stride - 1) // stride
    else:
        oh, ow = (h - kh) // stride + 1, (ww_ - kw) // stride + 1
    return g.add_node(Node(name, "convolution", [x.name, w.name],
                           {"stride": stride, "padding": padding,
                            "activation": activation}, (n, oh, ow, cout)))


def matmul(name, x: GraphTensor, w: GraphTensor, *, activation=None):
    g = current_graph()
    shape = (*x.shape[:-1], w.shape[-1])
    return g.add_node(Node(name, "matmul", [x.name, w.name],
                           {"activation": activation}, shape))


def add(name, a: GraphTensor, b: GraphTensor, *, activation=None):
    g = current_graph()
    return g.add_node(Node(name, "add", [a.name, b.name],
                           {"activation": activation}, a.shape))


def relu(name, x: GraphTensor):
    g = current_graph()
    return g.add_node(Node(name, "relu", [x.name], {}, x.shape))


def max_pool(name, x: GraphTensor, k: int = 2):
    g = current_graph()
    n, h, w, c = x.shape
    return g.add_node(Node(name, "max_pool", [x.name], {"k": k},
                           (n, h // k, w // k, c)))


def batch_norm(name, x: GraphTensor):
    g = current_graph()
    g.params[name + "_scale"] = np.ones((x.shape[-1],), np.float32)
    g.params[name + "_bias"] = np.zeros((x.shape[-1],), np.float32)
    return g.add_node(Node(name, "batch_norm", [x.name], {}, x.shape))


def flatten(name, x: GraphTensor):
    g = current_graph()
    n = x.shape[0]
    rest = int(np.prod(x.shape[1:]))
    return g.add_node(Node(name, "flatten", [x.name], {}, (n, rest)))
