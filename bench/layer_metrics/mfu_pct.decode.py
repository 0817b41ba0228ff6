"""Decode steps' model operations over their time, a share of the bf16
peak."""
from layer_metrics._mfu import mfu_pct


def read(record):
    return mfu_pct(record, "decode")
