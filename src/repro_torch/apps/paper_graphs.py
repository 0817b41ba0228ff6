"""Table-III paper networks as repro_torch.core.graph Graphs."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.paper_nets import PaperNet
from repro_torch.core.graph import (Graph, batch_norm, convolution, flatten,
                                    input_data, matmul, max_pool, weight)


def build_paper_graph(net: PaperNet, batch: int = 1,
                      rng: np.random.Generator | None = None) -> Graph:
    """Build a Table-III network as a Graph.  The weights are drawn from
    ``rng`` (default ``np.random.default_rng(0)``) by the same calls in the
    same order as the JAX package's ``build_paper_graph``, so the params of
    one seed are the reference's, bit for bit."""
    rng = rng or np.random.default_rng(0)
    h, w, c = net.input_shape
    with Graph(name=net.name, backend="mxu") as g:
        x = input_data("input", np.zeros((batch, h, w, c), np.float32))
        ci = 0
        cur_c = c
        flat = False
        for layer in net.layers:
            ci += 1
            kind = layer[0]
            if kind == "conv":
                _, cout, kh, kw, stride = layer
                wgt = weight(f"w{ci}", rng.standard_normal(
                    (kh, kw, cur_c, cout)) * (1.0 / np.sqrt(kh * kw * cur_c)))
                x = convolution(f"conv{ci}", x, wgt, stride=stride,
                                padding="same", activation="relu")
                cur_c = cout
            elif kind == "pool":
                x = max_pool(f"pool{ci}", x, layer[1])
            elif kind == "bn":
                x = batch_norm(f"bn{ci}", x)
            elif kind == "fc":
                if not flat:
                    x = flatten(f"flat{ci}", x)
                    flat = True
                cout = layer[1]
                wgt = weight(f"w{ci}", rng.standard_normal(
                    (x.shape[-1], cout)) * (1.0 / np.sqrt(x.shape[-1])))
                x = matmul(f"fc{ci}", x, wgt, activation="relu")
        # classifier head
        if not flat:
            x = flatten("flat_out", x)
        wgt = weight("w_out", rng.standard_normal(
            (x.shape[-1], net.n_classes)) * 0.05)
        matmul("logits", x, wgt)
    return g
