"""Readings of the program's spans over the traced units of one kind
(``yardstick.program_trace``): the device time of what a set of spans
launched, as a share of the units' busy time, and the blocking runtime
calls inside a span a unit.  Each is None where the trace holds nothing
that those spans launched, or where fewer than ``PAIRED`` of the trace's
kernels were paired with the host op that launched them."""
from layer_metrics._common import traced_only
from yardstick.trace import busy_seconds

PAIRED = 0.99


def _sound(record, kind, names):
    """The traced units, where every one is of ``kind``, the trace holds
    the program's spans, its kernels found their host ops and something
    was launched under one of ``names``; else None."""
    units = traced_only(record, kind)
    trace = record["trace"]
    if not units or "launch" not in trace or trace["paired"] is None \
            or trace["paired"] < PAIRED \
            or not any(n in names for n in trace["launch"]):
        return None
    return units


def launched_pct(record, kind, names):
    """100 x the device time of the items launched under any span of
    ``names`` (the innermost at their host op), inside the traced region,
    over the traced units' busy time."""
    if not _sound(record, kind, names):
        return None
    trace = record["trace"]
    lo, hi = trace["region"]
    took = sum(max(0.0, min(b, hi) - max(a, lo))
               for (_, a, b), n in zip(trace["device"], trace["launch"])
               if n in names)
    return 100.0 * took / busy_seconds(trace)


def blocking_per_unit(record, kind, name):
    """The blocking runtime calls that start inside a span ``name``, over
    the traced units (a count; 0 is a reading)."""
    units = _sound(record, kind, (name,))
    if not units:
        return None
    trace = record["trace"]
    inside = [(a, b) for n, a, b in trace["program_spans"] if n == name]
    calls = sum(any(a <= t < b for a, b in inside)
                for _, t, _ in trace["blocking"])
    return calls / len(units)
