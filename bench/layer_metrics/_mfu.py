"""The model step's share of the card's bf16 peak over untraced units of
one kind: their model operations (``yardstick.counts.model_flops``) over
the sum of their host-clock times."""
from layer_metrics._common import untraced
from yardstick.counts import PEAK_FLOPS, model_flops


def mfu_pct(record, kind):
    units = untraced(record, kind)
    seconds = sum(u["end"] - u["start"] for u in units)
    if not units or seconds <= 0:
        return None
    ops = sum(model_flops(record["spec"], u["size"], u["first"], u["n"])
              for u in units)
    return 100.0 * ops / (seconds * PEAK_FLOPS["bf16"])
