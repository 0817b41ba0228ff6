"""The program's spans in a trace (``yardstick.program_trace``): each
device item put down to the innermost program span of the host op that
launched it, paired by correlation ids; the blocking runtime calls; the
idle gaps by program span; the readings of ``layer_metrics/_spans.py``;
and ``tools/program_spans.py``'s window on the CPU."""
import random
import sys
from pathlib import Path

import pytest
from torch.autograd import DeviceType

from layer_metrics import _spans
from yardstick import program_trace, trace

CPU = DeviceType.CPU
S = "repro_torch."


class Ev:
    """A profiler event: a host op (``link`` 0, its own ``corr``), or a
    device item or runtime call naming its host op by ``link``."""

    def __init__(self, name, t0, t1, device=DeviceType.CUDA, note=False,
                 corr=0, link=0):
        self._n, self._t0, self._t1 = name, t0, t1
        self._d, self._note = device, note
        self._corr, self._link = corr, link

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._t0 * 1e9)

    def duration_ns(self):
        return int((self._t1 - self._t0) * 1e9)

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._note

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._link


def _bench_events():
    """The benchmark's own: two units, a decode step in each, a copy."""
    return [Ev("unit", 0.0, 1.0, CPU, True, corr=1),
            Ev("unit", 1.0, 2.0, CPU, True, corr=2),
            Ev("decode_step", 0.05, 0.95, CPU, True, corr=3),
            Ev("token_copy", 1.5, 1.9, CPU, True, corr=4)]


def _program_events():
    """A decode step's span holding decode attention's, the host ops under
    them and the runtime calls; the device items linked to the ops."""
    return [
        Ev(S + "serve.decode", 0.1, 0.9, CPU, True, corr=20),
        Ev(S + "attn.decode", 0.3, 0.5, CPU, True, corr=21),
        Ev("aten::mm", 0.2, 0.21, CPU, corr=10),
        Ev("aten::copy_", 0.35, 0.36, CPU, corr=11),
        Ev("aten::add", 1.2, 1.21, CPU, corr=12),
        # the profiler's own, repeating an op's id
        Ev("Activity Buffer Request", 0.8, 0.81, CPU, corr=11),
        # runtime calls: their own correlation ids may equal an op's
        Ev("cudaLaunchKernel", 0.2, 0.201, CPU, corr=11, link=10),
        Ev("cudaStreamSynchronize", 0.6, 0.7, CPU, corr=30, link=0),
        Ev("cudaMemcpyAsync", 1.55, 1.56, CPU, corr=31, link=12),
        Ev("cudaMalloc_v3020", 0.4, 0.41, CPU, corr=32, link=11),
        Ev("cudaFree", 3.5, 3.6, CPU, corr=33, link=0),            # outside the region
        Ev(S + "attn.decode", 0.3, 0.5, note=True),   # the device's range
        Ev("gemm_kernel", 0.22, 0.3, corr=40, link=10),
        Ev("elementwise_kernel", 0.4, 0.6, corr=41, link=11),
        Ev("add_kernel", 1.25, 1.3, corr=42, link=12),
        Ev("Memcpy DtoH (Device -> Pageable)", 1.6, 1.7, corr=43, link=12),
        Ev("orphan_kernel", 1.8, 1.85, corr=44, link=99),
        # launched through ctypes inside attn.decode, outside any op: the
        # profiler links it to its runtime call, whose id it shares
        Ev("cudaLaunchKernel", 0.45, 0.451, CPU, corr=45),
        Ev("own_kernel", 0.6, 0.62, corr=45, link=45),
    ]


def _reduced():
    events = _bench_events() + _program_events()
    r = trace.reduce(events, [7, 8])
    return {**r, **program_trace.reduce(events, r)}


def test_device_items_go_to_the_innermost_span_of_their_host_op():
    r = _reduced()
    assert [d[0] for d in r["device"]] == [
        "gemm_kernel", "elementwise_kernel", "own_kernel", "add_kernel",
        "Memcpy DtoH (Device -> Pageable)", "orphan_kernel"]
    assert r["launch"] == [S + "serve.decode", S + "attn.decode",
                           S + "attn.decode", None, None, None]
    # the orphan's op and call are absent; own_kernel paired by its call
    assert r["paired"] == pytest.approx(4 / 5)
    assert r["paired_by_op"] == pytest.approx(3 / 5)
    assert [s[0] for s in r["program_spans"]] == [S + "serve.decode",
                                                  S + "attn.decode"]


def test_the_runtime_call_comes_before_a_linked_op():
    """Ops' and runtime calls' ids are two series: a link that names an op
    of the same number does not outweigh the item's own call."""
    events = _bench_events() + _program_events() + [
        Ev("aten::fill_", 1.4, 1.41, CPU, corr=45)]
    r = trace.reduce(events, [7, 8])
    r = {**r, **program_trace.reduce(events, r)}
    assert r["launch"][2] == S + "attn.decode"


def test_blocking_keeps_waits_inside_the_region():
    r = _reduced()
    assert [b[0] for b in r["blocking"]] == ["cudaMalloc",
                                             "cudaStreamSynchronize"]


def test_program_spans_leave_the_benchmark_s_reduction_as_it_was():
    plain = trace.reduce(_bench_events() + [
        e for e in _program_events() if e.device_type() == DeviceType.CUDA
        and not e.is_user_annotation()], [7, 8])
    full = _reduced()
    for key in plain:
        assert full[key] == plain[key], key
    assert trace.breakdown(full) == trace.breakdown(plain)


def test_idle_gaps_by_program_span():
    r = _reduced()
    gaps = dict(program_trace.idle_gaps_program(r))
    # busy [0.22, 0.3) [0.4, 0.62) [1.25, 1.3) [1.6, 1.7) [1.8, 1.85), 0.5
    # s; the gaps' middles: 0.11 in serve.decode, 0.35 in attn.decode, the
    # rest outside (0.935 is past serve.decode, inside decode_step)
    assert gaps[S + "serve.decode"] == pytest.approx(0.22)
    assert gaps[S + "attn.decode"] == pytest.approx(0.1)
    assert gaps["outside"] == pytest.approx(2.0 - 0.5 - 0.22 - 0.1)
    assert dict(trace.breakdown(r)["idle_gaps"])["decode_step"] \
        == pytest.approx(0.22 + 0.1 + 0.63)


def test_innermost_matches_a_scan_of_every_span():
    rnd = random.Random(5)

    def nest(lo, hi, depth, out):
        t = lo
        while depth and t < hi - 1:
            a = rnd.uniform(t, hi - 1)
            b = rnd.uniform(a + 0.5, min(hi, a + 5))
            out.append((f"s{len(out)}", a, b))
            nest(a, b, depth - 1, out)
            t = b
        return out
    spans = nest(0.0, 50.0, 4, [])
    times = [rnd.uniform(-1, 51) for _ in range(400)] + [None]

    def scan(t):
        inside = [s for s in spans if t is not None and s[1] <= t < s[2]]
        return min(inside, key=lambda s: s[2] - s[1])[0] if inside else None
    assert program_trace.innermost(spans, times) == [scan(t) for t in times]


def _record(kind="decode", units=2):
    r = _reduced()
    return {"spec": {}, "traffic": {}, "trace": r,
            "units": [{"kind": kind, "traced": True} for _ in range(units)]
            + [{"kind": kind, "traced": False}]}


def test_launched_share_by_hand():
    rec = _record()
    busy = 0.08 + 0.22 + 0.05 + 0.1 + 0.05
    rec["trace"]["paired"] = 1.0
    assert _spans.launched_pct(rec, "decode", (S + "attn.decode",)) \
        == pytest.approx(100 * 0.22 / busy)
    assert _spans.launched_pct(
        rec, "decode", (S + "attn.decode", S + "serve.decode")) \
        == pytest.approx(100 * 0.3 / busy)


def test_blocking_calls_per_unit_by_hand():
    rec = _record()
    rec["trace"]["paired"] = 1.0
    # cudaMalloc at 0.4 and cudaStreamSynchronize at 0.6, in serve.decode
    assert _spans.blocking_per_unit(rec, "decode", S + "serve.decode") == 1.0
    rec["trace"]["blocking"] = []
    assert _spans.blocking_per_unit(rec, "decode", S + "serve.decode") == 0.0


@pytest.mark.parametrize("change", ["no span", "unpaired", "no program",
                                    "other kind"])
def test_readings_are_none_without_what_they_read(change):
    rec = _record()
    rec["trace"]["paired"] = 1.0
    kind = "decode"
    if change == "no span":
        rec["trace"]["launch"] = [None] * len(rec["trace"]["launch"])
    elif change == "unpaired":
        rec["trace"]["paired"] = 0.98
    elif change == "no program":
        for key in ("program_spans", "launch", "paired", "blocking"):
            del rec["trace"][key]
    else:
        kind = "prefill"
    assert _spans.launched_pct(rec, kind, (S + "attn.decode",)) is None
    assert _spans.blocking_per_unit(rec, kind, S + "serve.decode") is None


def test_the_tool_reads_a_window_on_the_cpu(cell_of):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import program_spans
    out = program_spans.read(cell_of("phi3-decode"), 2**33 + 5, 2.5, "cpu")
    assert out["spans"][S + "serve.decode"] == 2      # two traced steps
    assert out["spans"][S + "attn.decode"] == 2 * 2   # a layer each
    assert {S + "norm", S + "rope"} <= set(out["spans"])
    # no device in the trace: nothing launched, nothing read
    assert out["kernels"] == 0 and out["paired"] is None
    assert set(out["readings"]) == set(program_spans.READINGS)
    assert all(v is None for v in out["readings"].values())
    assert out["step_ms"]["traced"]["n"] == 2
