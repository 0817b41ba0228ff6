"""A kernel's share of its roofline over the traced prefills: the sum of
each launch's least time (``yardstick.counts``) over the sum of the
launches' measured time on the device.  Every traced prefill runs the
kernel once a layer; where the trace holds another count, the launches
cannot be told apart and nothing is read."""
from layer_metrics._common import traced_only
from yardstick.counts import least_seconds


def roofline_pct(record, name_part, cost, precision):
    """``cost(unit)`` -> (operations, bytes) of one launch in a prefill
    unit."""
    units = traced_only(record, "prefill")
    if not units:
        return None
    launches = [k for k in record["trace"]["kernels"] if name_part in k[0]]
    layers = record["spec"]["model"]["n_layers"]
    took = sum(b - a for _, a, b in launches)
    if len(launches) != layers * len(units) or took <= 0:
        return None
    least = layers * sum(least_seconds(*cost(u), precision) for u in units)
    return 100.0 * least / took
