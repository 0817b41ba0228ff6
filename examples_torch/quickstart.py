"""Quickstart: the SMAUG-style declarative graph API (paper Fig 2) and the
full-stack evaluation loop on one residual unit, run on the card.

The port's counterpart of ``examples/quickstart.py``: the same unit from the
same seeds, serialized in the same schema, executed with the fusion pass
(both convolutions on the NVDLA matmul kernel), then the tiling optimizer
and the runtime scheduler on 4 simulated accelerators, both at one H100's
constants (``core/tiling.py``, ``sim/hw.py``).

  PYTHONPATH=src python examples_torch/quickstart.py
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core.device import resolve_device
from repro_torch.core.graph import (Graph, add, convolution, input_data,
                                    weight)
from repro_torch.core.scheduler import simulate
from repro_torch.core.tensor import TensorSpec
from repro_torch.core.tiling import choose_tiling


def create_residual_unit():
    rng = np.random.default_rng(0)
    with Graph(name="residual", backend="mxu") as g:
        # tensor initialization (inside the context, as in the paper)
        inputs = input_data("input", rng.random((1, 32, 32, 8),
                                                dtype=np.float32))
        filter0 = weight("f0", rng.standard_normal((3, 3, 8, 64)) * 0.1)
        filter1 = weight("f1", rng.standard_normal((3, 3, 64, 8)) * 0.1)
        # network topology:
        x = convolution("conv0", inputs, filter0, stride=1, padding="same",
                        activation="relu")
        x = convolution("conv1", x, filter1, stride=1, padding="same")
        add("add", x, inputs, activation="relu")   # residual
    return g


def feeds():
    """The input the unit is executed on."""
    return {"input": np.random.default_rng(1).random((1, 32, 32, 8),
                                                     dtype=np.float32)}


def main(argv=None):
    """Returns a dict: ``graph``, ``outputs`` (tensors on the device),
    ``choice`` (the tiling) and ``timeline`` (the 4-worker schedule)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/residual_torch",
                    help="path stem of the graph's .json and .npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    graph = create_residual_unit()
    graph.write_graph(args.out)                     # graph serialization
    print(f"graph: {len(graph.nodes)} nodes -> {args.out}.json/.npz")

    # execute through the runtime (with automatic operator fusion)
    out = graph.execute(feeds(), device=device)
    print("outputs:", {k: tuple(v.shape) for k, v in out.items()})

    # the tiling optimizer at work (paper §II-B)
    spec = TensorSpec((1, 32, 32, 64), "NHWC", "float32")
    choice = choose_tiling(spec, max_tile_elems=16384, reduce_dim="C")
    print("tiling optimizer chose:", choice)

    # the runtime scheduler on 4 simulated accelerators (paper §II-C)
    tl = simulate(graph.tile_tasks(), n_workers=4)
    print(f"4-worker makespan: {tl.makespan*1e6:.1f} us, "
          f"utilization {tl.utilization():.2f}")
    print(tl.ascii(width=60))
    return {"graph": graph, "outputs": out, "choice": choice, "timeline": tl}


if __name__ == "__main__":
    main()
