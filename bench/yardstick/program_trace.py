"""The program's own spans in a traced window, and what each one holds.

``yardstick.trace`` keeps the benchmark's spans and the device's
intervals.  The program (``repro_torch.core.spans``) records spans of its
own in the same trace while a profiler records, ``record_function`` ranges
named ``repro_torch.<layer>`` on the trace's clock.  ``reduce(events,
trace)`` reads them from the events that ``trace.reduce`` reduced, beside
its result:

  ``program_spans``  [(name, start, end)] of the program's spans;
  ``launch``         one entry for each item of ``trace["device"]``, in its
                     order: the name of the innermost program span that
                     holds the host call that launched it, or None.  The
                     call is the runtime's (``cudaLaunchKernel``,
                     ``cudaMemcpyAsync``), whose ``correlation_id()`` is
                     the item's own; where the trace lacks it, the host
                     op that the item's ``linked_correlation_id()`` names,
                     as the profiler's own parsing pairs them (the op's
                     ``correlation_id()``: another series of numbers than
                     the runtime's, so the call is asked first).  A call
                     lies inside its op, and the spans nest, so both give
                     one span;
  ``paired``         the share of the trace's kernels paired either way,
                     and ``paired_by_op`` by a linked op (a kernel of the
                     program's own, launched through ``ctypes`` outside
                     any op, has none); None without kernels;
  ``blocking``       [(name, start, end)] of the CUDA runtime calls inside
                     the traced region that make the host wait for the
                     device (``BLOCKING``).

``idle_gaps_program(trace)`` puts each idle gap of the device down to the
innermost program span that holds the gap's middle, or to ``outside``.
Times are seconds on the trace's clock.  The program's spans nest on one
thread, so one sweep over them, sorted by start, with a stack, answers
every query.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from yardstick.trace import _DEVICE_KINDS, _kind, busy_intervals

PREFIX = "repro_torch."
# the runtime calls after which the host has waited for the device:
# synchronizations, the synchronous copy (not cudaMemcpyAsync), and the
# allocator's own calls to the driver
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize", "cudaMemcpy", "cudaMalloc",
                      "cudaFree"})
_VERSION = re.compile(r"_v\d+$")     # a runtime call's API version suffix
# the CUDA runtime's and driver's calls (``cudaLaunchKernel``,
# ``cuLaunchKernelEx``), told by name: not every torch's events carry an
# activity type
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")

Span = Tuple[str, float, float]


def _host_kind(e) -> Optional[str]:
    """What a host event is: ``"op"``, an op or a span, whose correlation
    id is its own; ``"call"``, a runtime call; None, the profiler's own
    events (``Activity Buffer Request`` repeats an op's id)."""
    if e.is_user_annotation() or "::" in e.name():
        return "op"
    return "call" if RUNTIME_CALL.match(e.name()) else None


def innermost(spans: Sequence[Span],
              times: Sequence[Optional[float]]) -> List[Optional[str]]:
    """For each time of ``times`` (None for none), the name of the
    innermost span of ``spans`` whose [start, end) holds it, or None.  The
    spans nest (or are disjoint)."""
    order = sorted(spans, key=lambda s: (s[1], -s[2]))
    asked = sorted((t, i) for i, t in enumerate(times) if t is not None)
    out: List[Optional[str]] = [None] * len(times)
    stack: List[Span] = []
    nxt = 0
    for t, i in asked:
        while nxt < len(order) and order[nxt][1] <= t:
            s = order[nxt]
            nxt += 1
            while stack and stack[-1][2] <= s[1]:
                stack.pop()
            stack.append(s)
        while stack and stack[-1][2] <= t:
            stack.pop()
        out[i] = stack[-1][0] if stack else None
    return out


def reduce(events, trace: Optional[Dict]) -> Optional[Dict]:
    """{"program_spans", "launch", "paired", "paired_by_op", "blocking"}
    of ``events``, the events that ``trace.reduce`` made ``trace`` of;
    None where ``trace`` is None."""
    from torch.autograd import DeviceType
    if trace is None:
        return None
    lo, hi = trace["region"]
    ops: Dict[int, float] = {}       # a host op's correlation id: its start
    calls: Dict[int, float] = {}     # a runtime call's
    spans: List[Span] = []
    blocking: List[Span] = []
    device = []
    for e in events:
        t0 = e.start_ns() * 1e-9
        t1 = t0 + e.duration_ns() * 1e-9
        link = e.linked_correlation_id()
        if e.device_type() == DeviceType.CUDA:
            kind = _kind(e)
            if kind in _DEVICE_KINDS:
                device.append((t0, kind, link, e.correlation_id()))
            continue
        kind = _host_kind(e)
        if kind == "call":
            calls[e.correlation_id()] = t0
            name = _VERSION.sub("", e.name())
            if name in BLOCKING and lo <= t0 < hi:
                blocking.append((name, t0, t1))
        elif kind == "op" and link == 0:
            ops[e.correlation_id()] = t0
            if e.is_user_annotation() and e.name().startswith(PREFIX):
                spans.append((e.name(), t0, t1))
    # trace.reduce's order: the events' order, sorted (stably) by start
    device.sort(key=lambda d: d[0])
    by_op = [ops.get(link) if link else None for _, _, link, _ in device]
    host = [calls.get(corr, t) for t, (_, _, _, corr) in zip(by_op, device)]
    kernels = [i for i, d in enumerate(device) if d[1] == "kernel"]

    def share(times):
        return sum(times[i] is not None for i in kernels) / len(kernels) \
            if kernels else None
    return {"program_spans": sorted(spans, key=lambda s: s[1]),
            "launch": innermost(spans, host), "paired": share(host),
            "paired_by_op": share(by_op),
            "blocking": sorted(blocking, key=lambda s: s[1])}


def idle_gaps_program(trace, top: int = 10) -> List[List]:
    """``trace.breakdown``'s idle gaps, summed by the innermost program
    span at each gap's middle (``outside`` where none holds it), the
    largest ``top``."""
    lo, hi = trace["region"]
    busy = busy_intervals(trace["device"], trace["region"])
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    names = innermost(trace["program_spans"],
                      [0.5 * (a + b) for a, b in gaps])
    idle: Dict[str, float] = {}
    for (a, b), name in zip(gaps, names):
        idle[name or "outside"] = idle.get(name or "outside", 0.0) + (b - a)
    return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])
            ][:top]
