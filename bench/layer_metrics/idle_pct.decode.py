"""Idle share of the card over traced decode steps."""
from layer_metrics._idle import idle_pct


def read(record):
    return idle_pct(record, "decode")
