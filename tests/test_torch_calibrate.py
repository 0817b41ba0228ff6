"""The port's calibration loop held against the JAX package's.

The grids, the (flops, bytes) accounting, the fit, the measured table and
the report are the reference's (``repro/kernels/calibrate.py``,
``repro/sim/backends.py``): on the synthetic records of
``tests/test_backends.py`` they agree to 1e-12.  The one difference is the
roofline's default constants (the H100's, not the v5e's), so
``roofline_mape`` is compared with both given the v5e constants.  Timing
is not asserted: on the CPU the plain versions run, and their times say
nothing about the card.
"""
import json
import math

import numpy as np
import pytest
import torch

from repro.kernels import calibrate as jcal
from repro.sim import backends as jbackends
from repro.sim import hw as jhw
from repro_torch.kernels import calibrate as tcal
from repro_torch.sim import backends as tbackends
from repro_torch.sim import hw as thw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COSTS = {"matmul": "matmul_cost", "attention": "attention_cost",
         "mamba": "mamba_cost"}


def _synthetic_records():
    """tests/test_backends.py::test_calibrate_fit_on_synthetic_records."""
    rng = np.random.default_rng(11)
    peak, bw, c = 8e11, 3e10, 1e-5
    records = []
    for kernel in ("matmul", "attention", "mamba"):
        for _ in range(6):
            f = float(rng.uniform(1e7, 1e10))
            b = float(rng.uniform(1e5, 1e8))
            records.append({"kernel": kernel, "kind": kernel,
                            "shape": [1], "flops": f, "bytes": b,
                            "measured_s": f / peak + b / bw + c})
    return records


def _close(a, b):
    """Equal to 1e-12, relative, through nested dicts and lists."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            assert a is b
        else:
            assert a == pytest.approx(b, rel=1e-12, abs=1e-300)
    else:
        assert a == b


def test_grids_and_constants_equal_reference():
    assert tcal.MATMUL_GRID == jcal.MATMUL_GRID
    assert tcal.ATTENTION_GRID == jcal.ATTENTION_GRID
    assert tcal.MAMBA_GRID == jcal.MAMBA_GRID
    assert tcal.QUICK_GRIDS == jcal.QUICK_GRIDS
    assert tcal.FULL_GRIDS == jcal.FULL_GRIDS
    assert tcal.KERNELS == jcal.KERNELS
    assert tcal.BYTES == jcal.BYTES
    assert set(tcal.GRIDS) == {"quick", "full", "model"}


@pytest.mark.parametrize("grid", ["quick", "full", "model"])
def test_costs_equal_reference_on_every_grid_shape(grid):
    for kernel, fn in COSTS.items():
        for shape in tcal.GRIDS[grid][kernel]:
            assert getattr(tcal, fn)(*shape) == getattr(jcal, fn)(*shape)
    assert tcal.attention_cost(1, 2, 1, 64, 32, causal=False) \
        == jcal.attention_cost(1, 2, 1, 64, 32, causal=False)


def test_model_grids_have_distinct_flops():
    """At least 4 shapes per kernel (the fit has 3 parameters), with
    pairwise-distinct flops (the table's exact round trip keys on them)."""
    assert set(tcal.MODEL_GRIDS) == set(tcal.KERNELS)
    for kernel, shapes in tcal.MODEL_GRIDS.items():
        flops = [getattr(tcal, COSTS[kernel])(*s)[0] for s in shapes]
        assert len(shapes) >= 4, kernel
        assert len(set(flops)) == len(flops), kernel


def test_fit_and_mape_equal_reference():
    rng = np.random.default_rng(5)
    f = rng.uniform(1e6, 1e10, 40)
    b = rng.uniform(1e4, 1e8, 40)
    noise = rng.uniform(0.9, 1.1, 40)
    for t in (f / 3.7e12 + b / 6.1e10 + 2.4e-5,          # recoverable
              (f / 3.7e12 + b / 6.1e10 + 2.4e-5) * noise,
              4.2e-4 - 1e-16 * f):                       # a dropped term
        ours, theirs = tbackends.fit_linear_cost(f, b, t), \
            jbackends.fit_linear_cost(f, b, t)
        np.testing.assert_allclose(ours.pop("pred"), theirs.pop("pred"),
                                   rtol=1e-12)
        _close(ours, theirs)
        assert tbackends.mape(t * noise, t) == pytest.approx(
            jbackends.mape(t * noise, t), rel=1e-12)


def test_table_lookup_equals_reference():
    recs = _synthetic_records() + [
        {"kind": "", "flops": 3e8, "measured_s": 2e-3}]
    ours, theirs = tbackends.table_from_samples(recs), \
        jbackends.table_from_samples(recs)
    assert ours.samples == theirs.samples
    probes = [r["flops"] for r in recs] + [1e6, 5e8, 2e9, 1e11]
    for kind in ("matmul", "attention", "mamba", "", "conv"):
        for flops in probes:
            assert ours._lookup(kind, flops) == pytest.approx(
                theirs._lookup(kind, flops), rel=1e-12)
    with pytest.raises(ValueError):
        tbackends.TableBackend(samples=())


def test_table_op_time():
    table = tcal.table_backend(_synthetic_records())

    class Op:
        def __init__(self, flops, op_kind="matmul", duration_s=None):
            self.flops, self.op_kind, self.duration_s = \
                flops, op_kind, duration_s

    rec = _synthetic_records()[0]
    assert table.op_time(Op(rec["flops"])) == rec["measured_s"]
    assert table.op_time(Op(0.0)) == 0.0
    assert table.op_time(Op(1e9, duration_s=7e-3)) == 7e-3


def _without_roofline(fits):
    """The fits without roofline_mape, whose default constants differ."""
    return {k: {key: v for key, v in fit.items() if key != "roofline_mape"}
            for k, fit in fits.items()}


def test_calibrate_and_report_equal_reference():
    records = _synthetic_records()
    ours, theirs = tcal.calibrate(records), jcal.calibrate(records)
    _close(_without_roofline(ours), _without_roofline(theirs))
    meta = {"backend": "synthetic", "interpret": False, "grid": "synthetic",
            "repeat": 1}
    ours_rep = tcal.build_report(records, meta)
    theirs_rep = jcal.build_report(records, meta, theirs)
    for rep in (ours_rep, theirs_rep):
        rep["kernels"] = _without_roofline(rep["kernels"])
    _close(ours_rep, theirs_rep)
    for fit in ours.values():
        assert fit["fitted_mape"] < 1e-9 and fit["table_max_rel_err"] == 0.0
        assert fit["fitted_mape"] < fit["roofline_mape"]
    assert ours_rep["n_improved"] == 3


def test_roofline_pred_equals_reference_at_v5e_constants():
    records = _synthetic_records()
    np.testing.assert_allclose(
        tcal.roofline_pred(records, jhw.PEAK_FLOPS, jhw.HBM_BW),
        jcal.roofline_pred(records, jhw.PEAK_FLOPS, jhw.HBM_BW), rtol=1e-12)
    np.testing.assert_allclose(
        tcal.roofline_pred(records),
        jcal.roofline_pred(records, thw.PEAK_FLOPS, thw.HBM_BW), rtol=1e-12)
    assert (thw.PEAK_FLOPS, thw.HBM_BW) == (67e12, 3.35e12)


def test_measure_on_cpu_gives_reference_accounting():
    records, meta = tcal.measure(grid="quick", repeat=1, device="cpu")
    expect = [(k, list(s), *getattr(jcal, COSTS[k])(*s))
              for k in jcal.KERNELS for s in jcal.QUICK_GRIDS[k]]
    assert [(r["kernel"], r["shape"], r["flops"], r["bytes"])
            for r in records] == expect
    assert all(r["kind"] == r["kernel"] for r in records)
    assert all(math.isfinite(r["measured_s"]) and r["measured_s"] > 0
               for r in records)
    assert meta == {"backend": "cpu", "interpret": True, "grid": "quick",
                    "repeat": 1, "device": "cpu"}


def test_measure_inputs_are_stable_and_finite():
    """The seed is the kernel's name and shape, not Python's hash."""
    for kernel in tcal.KERNELS:
        shape = tcal.QUICK_GRIDS[kernel][0]
        one, _, _ = tcal._inputs(kernel, shape, torch.device("cpu"))
        two, _, _ = tcal._inputs(kernel, shape, torch.device("cpu"))
        for a, b in zip(one, two):
            assert torch.equal(a, b)
    args, _, _ = tcal._inputs("mamba", (1, 512, 16, 16), torch.device("cpu"))
    assert bool(torch.isfinite(tcal.ops.mamba_scan(*args)).all())


def test_measure_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcal.measure(grid="quick")
    with pytest.raises(ValueError, match="unknown grid"):
        tcal.measure(grid="huge", device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        tcal.measure(grid="quick", kernels=("conv",), device="cpu")


def test_cli_writes_report_on_cpu(tmp_path, capsys):
    out = tmp_path / "cal.json"
    tcal.main(["--grid", "quick", "--repeat", "1", "--device", "cpu",
               "--kernels", "matmul", "mamba", "--out", str(out)])
    report = json.loads(out.read_text())
    assert report["backend"] == "cpu" and report["interpret"] is True
    assert report["device"] == "cpu" and report["grid"] == "quick"
    assert sorted(report["kernels"]) == ["mamba", "matmul"]
    assert len(report["samples"]) == 4
    for fit in report["kernels"].values():
        assert fit["table_max_rel_err"] == 0.0
    assert "fitted_mape" in capsys.readouterr().err


@pytest.mark.parametrize("grid,tiles", [
    ("quick", {"attention": {"bq": 64, "bk": 64}}),
    ("full", {"attention": {"bq": 64, "bk": 64}}),
    ("model", {})])
def test_samples_carry_the_reference_tiles(grid, tiles, monkeypatch):
    """Attention is timed at bq = bk = 64 on the reference's ``quick`` and
    ``full`` grids, as ``repro/kernels/calibrate.py`` times it; the port's
    own ``model`` grid passes no tile (the kernels' defaults).  The calls
    are recorded, not run: the ``model`` grid is cut to its first shapes'
    smallest stand-ins."""
    calls = []

    def record(kernel):
        def call(*args, **kw):
            calls.append((kernel, kw))
            return args[0]
        return call
    monkeypatch.setattr(tcal, "_CALLS",
                        {k: record(k) for k in tcal._CALLS})
    if grid == "model":
        monkeypatch.setitem(tcal.GRIDS, "model", tcal.QUICK_GRIDS)
    tcal.measure(grid=grid, repeat=1, device="cpu")
    assert {k for k, _ in calls} == set(tcal.KERNELS)
    for kernel, kw in calls:
        assert kw == tiles.get(kernel, {}), (kernel, kw)
    assert tcal.GRID_TILES == {g: {"attention": {"bq": 64, "bk": 64}}
                               for g in ("quick", "full")}
