"""The device's idle share over the traced units of one kind: 1 less the
union of its intervals over the traced span."""
from layer_metrics._common import traced_only
from yardstick.trace import busy_seconds, window_seconds


def idle_pct(record, kind):
    if not traced_only(record, kind):
        return None
    trace = record["trace"]
    return 100.0 * (1.0 - busy_seconds(trace) / window_seconds(trace))
