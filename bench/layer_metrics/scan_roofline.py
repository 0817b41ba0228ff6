"""The Mamba1 scan kernel's share of its roofline in prefill (float32):
10 b S d N operations; its inputs, output and final state once."""
from layer_metrics._roofline import roofline_pct
from yardstick.counts import scan_cost


def read(record):
    m = record["spec"]["model"]
    d_in = m["ssm"]["expand"] * m["d_model"]
    return roofline_pct(
        record, "mamba_scan",
        lambda u: scan_cost(u["size"], u["n"], d_in, m["ssm"]["d_state"]),
        "fp32")
