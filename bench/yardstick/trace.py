"""The traced part of a ``--trace 1`` run and its reduction.

The profiler (``torch.profiler``, CPU and CUDA activities) is started
before one unit of the window and stopped after another, as the mix's
``trace`` entry says (``first_unit``, ``units``), so that it holds a few
steady seconds.  The benchmark's own spans (``unit``, ``make_batch``,
``prefill``, ``decode_step``, ``token_copy``, ``check_keep``) are
``record_function`` ranges around its calls; spans inside the program are
not read.  The reduction keeps the device's intervals (kernels, copies,
fills) and the spans, in seconds on the trace's clock.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

SPANS = ("make_batch", "prefill", "decode_step", "token_copy", "check_keep")
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class NoTrace:
    active = False

    def span(self, name):
        return contextlib.nullcontext()

    def before(self, unit: int):
        pass

    def after(self, unit: int):
        pass

    def finish(self):
        return None


class Tracer(NoTrace):
    """Profiles units ``first`` .. ``first + count - 1`` of the window."""

    def __init__(self, plan: Dict):
        self.first, self.count = plan["first_unit"], plan["units"]
        self.prof = None
        self.events = None
        self.traced: List[int] = []

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self, fn):
        """Profiles ``fn()`` once and drops the trace: the profiler's own
        first start belongs to set-up."""
        with self._profile():
            fn()

    def span(self, name):
        from torch.profiler import record_function
        return record_function(name) if self.active \
            else contextlib.nullcontext()

    def before(self, unit: int):
        if unit == self.first and self.prof is None:
            self.prof = self._profile()
            self.prof.start()
            self.active = True
        if self.active:
            self.traced.append(unit)
            self._unit = self.span("unit")
            self._unit.__enter__()

    def after(self, unit: int):
        if self.active:
            self._unit.__exit__(None, None, None)
            if unit == self.first + self.count - 1:
                self._stop()

    def _stop(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.active = False
        self.events = self.prof.profiler.kineto_results.events()

    def finish(self) -> Optional[Dict]:
        """The reduced trace, or None where the window closed before the
        traced units had all run."""
        if self.active:
            self._unit.__exit__(None, None, None)
            self._stop()
            return None
        if self.events is None or len(self.traced) != self.count:
            return None
        return reduce(self.events, self.traced)


def _kind(e) -> str:
    """The kind of a device event: its activity type where the event
    carries one, else told from its annotation flag and its name, as the
    profiler names copies and fills."""
    kind = getattr(e, "activity_type", None)
    if callable(kind):
        return str(kind())
    if e.is_user_annotation():
        return "gpu_user_annotation"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def reduce(events, traced: List[int]) -> Optional[Dict]:
    """{"device": [(name, start, end)] of kernels, copies and fills,
    "kernels": the kernels alone, "spans": [(name, start, end)] of the
    benchmark's spans, "region": (start, end) from the first traced unit's
    start to the last one's end, "units": the traced units' numbers}; times
    in seconds on the trace's clock."""
    from torch.autograd import DeviceType
    device, kernels, spans, units = [], [], [], []
    for e in events:
        t0 = e.start_ns() * 1e-9
        t1 = t0 + e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            kind = _kind(e)
            if kind not in _DEVICE_KINDS:
                continue
            device.append((e.name(), t0, t1))
            if kind == "kernel":
                kernels.append((e.name(), t0, t1))
        elif e.name() == "unit":
            units.append((t0, t1))
        elif e.name() in SPANS:
            spans.append((e.name(), t0, t1))
    if not units:
        return None
    device.sort(key=lambda x: x[1])
    kernels.sort(key=lambda x: x[1])
    return {"device": device, "kernels": kernels, "spans": spans,
            "region": (min(u[0] for u in units), max(u[1] for u in units)),
            "units": list(traced)}


def busy_intervals(device, region) -> List[Tuple[float, float]]:
    """The union of the device's intervals inside ``region``, sorted."""
    lo, hi = region
    out: List[List[float]] = []
    for _, a, b in device:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_seconds(trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace["device"],
                                                trace["region"]))


def window_seconds(trace) -> float:
    return trace["region"][1] - trace["region"][0]


def breakdown(trace, top: int = 10) -> Dict:
    """The device operations that took the most time, and the idle time
    between the device's intervals summed by the benchmark's span the
    host was in at the gap's middle (``between`` outside them all)."""
    ops: Dict[str, float] = {}
    for name, a, b in trace["device"]:
        ops[name] = ops.get(name, 0.0) + (b - a)
    busy = busy_intervals(trace["device"], trace["region"])
    edges = [trace["region"][0]] + [x for ab in busy for x in ab] \
        + [trace["region"][1]]
    idle: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inside = [s for s in trace["spans"] if s[1] <= mid < s[2]]
        name = min(inside, key=lambda s: s[2] - s[1])[0] if inside \
            else "between"
        idle[name] = idle.get(name, 0.0) + (b - a)

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]
    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
