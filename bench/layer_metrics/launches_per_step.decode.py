"""Kernels launched a decode step: the device trace's kernels over the
traced decode steps, whose token copies each wait for the step's work."""
from layer_metrics._common import traced_only


def read(record):
    units = traced_only(record, "decode")
    if not units:
        return None
    return len(record["trace"]["kernels"]) / len(units)
