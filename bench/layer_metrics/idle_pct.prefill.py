"""Idle share of the card over traced prefill batches."""
from layer_metrics._idle import idle_pct


def read(record):
    return idle_pct(record, "prefill")
