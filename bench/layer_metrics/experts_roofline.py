"""The routed experts' grouped products' share of their roofline in MLA +
MoE prefill (bf16): each layer's gate, up and down products over the
experts' ragged groups (``torch._grouped_mm``'s kernel, three launches a
layer), priced together by ``yardstick.counts_mla_moe.experts_cost`` at
T k rows.  Where a traced prefill holds other than three launches a layer
of the kernel, the launches cannot be told apart and nothing is read."""
from layer_metrics._common import traced_only
from yardstick.counts import least_seconds
from yardstick.counts_mla_moe import experts_cost

NAME_PART = "GroupProblemShape"
PRODUCTS = 3


def read(record):
    units = traced_only(record, "prefill")
    if not units:
        return None
    m = record["spec"]["model"]
    e = m["moe"]
    launches = [k for k in record["trace"]["kernels"] if NAME_PART in k[0]]
    took = sum(b - a for _, a, b in launches)
    if len(launches) != PRODUCTS * m["n_layers"] * len(units) or took <= 0:
        return None
    least = m["n_layers"] * sum(
        least_seconds(*experts_cost(u["size"] * u["n"] * e["top_k"],
                                    m["d_model"], e["d_ff_expert"],
                                    e["n_experts"]), "bf16")
        for u in units)
    return 100.0 * least / took
