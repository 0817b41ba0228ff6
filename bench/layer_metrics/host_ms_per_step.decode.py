"""Host milliseconds a decode step spends from its call to its return,
before the token copy, averaged over the window's untraced decode steps."""
from layer_metrics._common import untraced


def read(record):
    units = untraced(record, "decode")
    if not units:
        return None
    return 1e3 * sum(u["ret"] - u["call"] for u in units) / len(units)
