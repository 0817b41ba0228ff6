"""Prefill's model operations over its time, a share of the bf16 peak, in
the MLA + MoE family: untraced prefill units, their operations
(``yardstick.counts_mla_moe.model_flops``: the active experts, the
expanded attention products, attention's live pairs at 640 operations a
head, the head) over the sum of their host-clock times."""
from layer_metrics._common import untraced
from yardstick.counts import PEAK_FLOPS
from yardstick.counts_mla_moe import model_flops


def read(record):
    units = untraced(record, "prefill")
    seconds = sum(u["end"] - u["start"] for u in units)
    if not units or seconds <= 0:
        return None
    ops = sum(model_flops(record["spec"], u["size"], u["first"], u["n"])
              for u in units)
    return 100.0 * ops / (seconds * PEAK_FLOPS["bf16"])
