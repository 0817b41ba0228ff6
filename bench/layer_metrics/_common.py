"""What the per-layer readers share: the units outside the traced part of
the window (their host clocks are free of the profiler's cost) and the
traced part's units."""


def untraced(record, kind):
    return [u for u in record["units"]
            if u["kind"] == kind and not u["traced"]]


def traced_only(record, kind):
    """The traced units, where every one is of ``kind``; else None."""
    trace = record["trace"]
    if trace is None:
        return None
    units = [u for u in record["units"] if u["traced"]]
    if not units or any(u["kind"] != kind for u in units) \
            or len(units) != len(trace["units"]):
        return None
    return units
