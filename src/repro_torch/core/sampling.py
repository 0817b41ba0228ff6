"""Sampled simulation with loop-tree unsampling (paper §II-E1): the port's
copy of the JAX package's ``repro.core.sampling``, held ``==`` against it.

Aladdin traces a few iterations of each loop (``setSamplingFactor``) and
"unsamples" latency up a loop tree.  ``LoopNode`` describes the static loop
tree (layers / KV chunks / microbatches / scan steps, ``model_loop_tree``);
``unsample`` multiplies measured body costs back to the full run;
``sampling_error`` validates a sampled estimate against the full
measurement.  On the card ``measure_sampled`` takes a function that times
``n`` launches of a kernel (CUDA events) and builds the node from two
sampled counts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


@dataclass
class LoopNode:
    """A loop level: ``trips`` iterations, each costing ``body`` plus
    children.  ``sampled_trips`` = how many iterations were actually
    measured (>=1)."""
    name: str
    trips: int
    body_cost: float = 0.0            # per-iteration cost OUTSIDE children
    children: List["LoopNode"] = field(default_factory=list)
    sampled_trips: int = 1

    def sampled_cost(self) -> float:
        """Cost of the measured (sampled) execution."""
        inner = sum(c.sampled_cost() for c in self.children)
        return self.sampled_trips * (self.body_cost + inner)

    def unsampled_cost(self) -> float:
        """Cost propagated to the FULL trip counts (the unsampling pass)."""
        inner = sum(c.unsampled_cost() for c in self.children)
        return self.trips * (self.body_cost + inner)

    def sampling_factor(self) -> float:
        s = self.sampled_cost()
        return self.unsampled_cost() / s if s else float("inf")


def unsample(root: LoopNode) -> float:
    return root.unsampled_cost()


def sampling_error(estimated: float, measured: float) -> float:
    """Relative error of the sampled estimate vs ground truth."""
    return abs(estimated - measured) / max(abs(measured), 1e-30)


def measure_sampled(fn: Callable[[int], float], trips: int,
                    sample: int) -> LoopNode:
    """Run ``fn(n_iters)`` for ``sample`` iterations, build the node.

    fn returns measured cost of executing n iterations; pipelined loops need
    sample >= 2 (paper: two iterations to expose the pipeline latency), so we
    measure fn(sample) and fn(sample-1) and use the marginal cost when
    possible."""
    sample = max(1, min(sample, trips))
    if sample >= 2:
        # two-point measurement: marginal cost separates the pipeline/startup
        # latency from the steady-state per-iteration cost (paper: "at least
        # two loop iterations are required to determine the pipeline latency")
        c_k = fn(sample)
        c_k1 = fn(sample - 1)
        per_iter = max(c_k - c_k1, 1e-12)
        startup = max(c_k - sample * per_iter, 0.0)
        wrapper = LoopNode(name="run", trips=1, body_cost=startup)
        wrapper.children.append(LoopNode("iters", trips=trips,
                                         body_cost=per_iter,
                                         sampled_trips=sample))
        return wrapper
    cost = fn(1)
    return LoopNode(name="run", trips=1, body_cost=0.0,
                    children=[LoopNode("iters", trips=trips, body_cost=cost,
                                       sampled_trips=1)])


def model_loop_tree(cfg, shape_kind: str, *, n_chunks: int = 0,
                    n_microbatches: int = 1) -> LoopNode:
    """The static loop tree of one step for a ModelConfig (layers x chunks x
    scan steps) — what the HLO analyzer multiplies through."""
    layers = LoopNode("layers", trips=cfg.n_layers)
    if n_chunks:
        layers.children.append(LoopNode("kv_chunks", trips=n_chunks))
    if cfg.family in ("ssm", "hybrid") and shape_kind != "decode":
        layers.children.append(LoopNode("scan_chunks", trips=max(
            1, getattr(cfg.ssm, "chunk", 256))))
    root = LoopNode("step", trips=1, children=[
        LoopNode("microbatches", trips=n_microbatches, children=[layers])])
    return root
