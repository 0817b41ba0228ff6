"""Prefill's model operations over its time, a share of the bf16 peak."""
from layer_metrics._mfu import mfu_pct


def read(record):
    return mfu_pct(record, "prefill")
