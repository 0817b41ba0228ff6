"""The port's camera ISP and frame launcher held against the JAX package's.

Each ISP stage is fed the reference's own input to that stage (the raw frame
run through the reference's earlier stages) and compared at atol 1e-5: the
stages are float32 stencils and pointwise maps on values of about [0, 2],
summed in another order than XLA's.  Frames: ``tests/test_optim.py``'s
(64, 96) -> (16, 16), and a larger (180, 320) -> (32, 32) whose height and
width the DNN size does not divide.
"""
import functools

import numpy as np
import pytest
import torch

from repro.apps import camera as RC
from repro.apps.paper_graphs import build_paper_graph as ref_build
from repro.configs.paper_nets import PAPER_NETS as REF_NETS
from repro_torch.apps import camera as TC
from repro_torch.apps.paper_graphs import build_paper_graph
from repro_torch.configs.paper_nets import PAPER_NETS
from repro_torch.launch import camera as launch

ATOL = 1e-5
FRAMES = {"64x96": ((64, 96), (16, 16)), "180x320": ((180, 320), (32, 32))}
STAGES = ["hot_pixel_suppression", "deinterleave", "demosaic",
          "white_balance", "color_correct", "gamma", "sharpen", "downsample"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(hw, seed=0):
    return np.random.default_rng(seed).random(hw, dtype=np.float32)


@functools.cache
def _stage_inputs(frame):
    """The reference's input to each stage of a frame: {stage: args}."""
    hw, dnn_hw = FRAMES[frame]
    raw = _raw(hw)
    args = {"hot_pixel_suppression": (raw,)}
    x = RC.hot_pixel_suppression(raw)
    args["deinterleave"] = (x,)
    planes = RC.deinterleave(x)
    args["demosaic"] = planes
    rgb = RC.demosaic(*planes)
    for stage in ("white_balance", "color_correct", "gamma", "sharpen"):
        args[stage] = (rgb,)
        rgb = getattr(RC, stage)(rgb)
    args["downsample"] = (rgb, dnn_hw)
    return args


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("frame", list(FRAMES))
@pytest.mark.parametrize("stage", STAGES)
def test_isp_stage_matches_reference(stage, frame):
    args = _stage_inputs(frame)[stage]
    expect = getattr(RC, stage)(*args)
    out = getattr(TC, stage)(*(_t(a) if not isinstance(a, tuple) else a
                               for a in args))
    if stage == "deinterleave":
        assert len(out) == len(expect) == 4
    else:
        out, expect = (out,), (expect,)
    for o, e in zip(out, expect):
        assert o.dtype == torch.float32 and tuple(o.shape) == e.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(e), atol=ATOL)


@pytest.mark.parametrize("frame", list(FRAMES))
def test_camera_pipeline_matches_reference(frame):
    """The whole ISP (``tests/test_optim.py``'s shapes-and-range case,
    against the reference's jitted pipeline)."""
    hw, dnn_hw = FRAMES[frame]
    raw = _raw(hw)
    rgb, dnn_in = TC.camera_pipeline(torch.from_numpy(raw), dnn_hw=dnn_hw)
    e_rgb, e_dnn = RC.camera_pipeline(raw, dnn_hw=dnn_hw)
    assert rgb.shape == (*hw, 3) and dnn_in.shape == (*dnn_hw, 3)
    assert float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0
    assert not bool(torch.isnan(rgb).any())
    np.testing.assert_allclose(rgb.numpy(), np.asarray(e_rgb), atol=ATOL)
    np.testing.assert_allclose(dnn_in.numpy(), np.asarray(e_dnn), atol=ATOL)


def test_convolve2d_same_flips_the_kernel():
    """A true convolution, as ``jax.scipy.signal.convolve2d``: an
    asymmetric kernel shows the flip."""
    import jax.scipy.signal as jss
    x = np.random.default_rng(1).random((6, 7), dtype=np.float32)
    k = [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0], [6.0, 7.0, 9.0]]
    expect = jss.convolve2d(x, np.asarray(k, np.float32), mode="same")
    np.testing.assert_allclose(TC._convolve2d_same(torch.from_numpy(x), k),
                               np.asarray(expect), rtol=1e-6, atol=1e-6)


def test_frame_matches_reference():
    """One frame through the ISP and CNN10, against the reference's ISP and
    ``Graph.execute`` (the measured half of
    ``examples/camera_pipeline.py``); logits at ``test_torch_graph.py``'s
    output tolerance."""
    raw = _raw((128, 192), seed=2)
    out = launch.run_frame(raw, build_paper_graph(PAPER_NETS["cnn10"]),
                           device="cpu")
    _, e_dnn = RC.camera_pipeline(raw, dnn_hw=launch.DNN_HW)
    (e_logits,) = ref_build(REF_NETS["cnn10"]).execute(
        {"input": np.asarray(e_dnn)[None]}).values()
    np.testing.assert_allclose(out["dnn_in"].numpy(), np.asarray(e_dnn),
                               atol=ATOL)
    np.testing.assert_allclose(out["logits"].numpy(), e_logits, rtol=1e-4,
                               atol=1e-4 * np.abs(e_logits).max())
    assert out["cls"] == int(np.argmax(e_logits))
    assert out["frame_ms"] == out["isp_ms"] + out["cnn_ms"] > 0
    assert out["meets_budget"] == (out["frame_ms"] < launch.BUDGET_MS)


def test_launcher_on_cpu(capsys):
    """``python -m repro_torch.launch.camera --device cpu``: a seeded 720p
    frame, the ISP, CNN10, and the frame against the budget."""
    out = launch.main(["--device", "cpu", "--seed", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert out["rgb"].shape == (720, 1280, 3)
    assert lines[0].startswith("ISP (720x1280 raw") and "on cpu" in lines[0]
    assert lines[1].startswith("CNN10 inference") and \
        f"class={out['cls']}" in lines[1]
    assert ("MEETS" if out["meets_budget"] else "MISSES") in lines[2]
    np.testing.assert_array_equal(launch.raw_frame(1),
                                  np.random.default_rng(1).random(
                                      (720, 1280), dtype=np.float32))


def test_launcher_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = build_paper_graph(PAPER_NETS["cnn10"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.run_frame(_raw((64, 64)), g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main([])
