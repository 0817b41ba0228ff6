"""The trace's reduction: device intervals, their union over the traced
region, the idle gaps named by the benchmark's spans."""
import pytest
from torch.autograd import DeviceType

from yardstick import trace


class Ev:
    def __init__(self, name, t0, t1, device=DeviceType.CUDA, note=False):
        self._n, self._t0, self._t1 = name, t0, t1
        self._d, self._note = device, note

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


CPU = DeviceType.CPU


def _events():
    return [Ev("unit", 0.0, 1.0, CPU, True), Ev("unit", 1.0, 2.0, CPU, True),
            Ev("prefill", 0.1, 0.9, CPU, True),
            Ev("token_copy", 1.5, 1.9, CPU, True),
            Ev("unit", 0.0, 2.0, note=True),        # the range on the device
            Ev("gemm_kernel", 0.2, 0.6), Ev("flash_fwd_wgmma", 0.5, 0.8),
            Ev("Memcpy DtoH (Device -> Pageable)", 1.6, 1.7),
            Ev("gemm_kernel", 3.0, 4.0)]           # outside the region


def test_reduce_keeps_device_intervals_and_spans():
    r = trace.reduce(_events(), [4, 5])
    assert r["region"] == (0.0, 2.0)
    assert [k[0] for k in r["kernels"]] == ["gemm_kernel", "flash_fwd_wgmma",
                                            "gemm_kernel"]
    assert len(r["device"]) == 4
    assert trace.busy_seconds(r) == pytest.approx(0.6 + 0.1)
    assert trace.window_seconds(r) == pytest.approx(2.0)


def test_breakdown_names_gaps_by_span():
    r = trace.reduce(_events(), [4, 5])
    b = trace.breakdown(r)
    ops = dict(b["device_ops"])
    assert ops["gemm_kernel"] == pytest.approx(0.4 + 1.0)
    gaps = dict(b["idle_gaps"])
    # [0, 0.2) and [0.8, 1.6) and [1.7, 2.0): the first gap's middle is in
    # prefill, the second's (1.2) in no span, the third's in token_copy
    assert abs(gaps["prefill"] - 0.2) < 1e-6
    assert abs(gaps["between"] - 0.8) < 1e-6
    assert abs(gaps["token_copy"] - 0.3) < 1e-6
