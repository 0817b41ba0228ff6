"""Camera-powered deep learning (paper §V) on one device: a raw 720p Bayer
frame -> the ISP -> a 32x32 DNN input -> CNN10 (batch 1), against a 33 ms
frame budget.  Every convolution and FC layer of CNN10 runs on the NVDLA
matmul kernel on the card.  ``run_frame`` is the counterpart of the
measured half of the JAX package's ``examples/camera_pipeline.py`` and
``frame_timeline`` of its simulated half (the lowered DNN priced on an SoC
after the measured ISP); ``examples_torch/camera_pipeline.py`` composes the
two.

  PYTHONPATH=src python -m repro_torch.launch.camera
  PYTHONPATH=src python -m repro_torch.launch.camera --device cpu --seed 1
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.apps.camera import camera_pipeline
from repro_torch.apps.paper_graphs import build_paper_graph
from repro_torch.configs.paper_nets import PAPER_NETS
from repro_torch.core.device import resolve_device
from repro_torch.core.timeline import Timeline
from repro_torch.sim.sweep import sweep

FRAME_HW = (720, 1280)
DNN_HW = (32, 32)
BUDGET_MS = 33.0


def raw_frame(seed=0):
    """A seeded 720x1280 raw frame, as the reference example makes it."""
    return np.random.default_rng(seed).random(FRAME_HW, dtype=np.float32)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_frame(raw, graph, device="cuda"):
    """One frame: ``raw`` (numpy or tensor, (H, W)) through the ISP on
    ``device``, then ``graph`` (CNN10 at batch 1) on its DNN input.  Host
    clock around each half, the device synced.  Returns a dict: ``rgb``,
    ``dnn_in``, ``logits`` (tensors on ``device``), ``cls``, ``isp_ms``,
    ``cnn_ms``, ``frame_ms`` and ``meets_budget``."""
    device = resolve_device(device)
    raw = torch.as_tensor(raw, dtype=torch.float32).to(device)
    _sync(device)
    t0 = time.perf_counter()
    rgb, dnn_in = camera_pipeline(raw, dnn_hw=DNN_HW)
    _sync(device)
    t1 = time.perf_counter()
    (logits,) = graph.execute({"input": dnn_in[None]}, device=device).values()
    cls = int(torch.argmax(logits))
    t2 = time.perf_counter()   # argmax's copy to the host synced the card
    isp_ms, cnn_ms = 1e3 * (t1 - t0), 1e3 * (t2 - t1)
    return {"rgb": rgb, "dnn_in": dnn_in, "logits": logits, "cls": cls,
            "isp_ms": isp_ms, "cnn_ms": cnn_ms, "frame_ms": isp_ms + cnn_ms,
            "meets_budget": isp_ms + cnn_ms < BUDGET_MS}


def frame_timeline(program, isp_s, config):
    """The Fig 19 frame: the measured ISP on the host lane ("cpu", the
    reference's name) from 0 to ``isp_s``, then ``program`` (the lowered
    DNN) as the engine schedules it under ``config``, appended after it."""
    (res,) = sweep(program, [config])
    tl = Timeline()
    tl.add("cpu", "isp", 0.0, isp_s, "host")
    for e in res.timeline.events:
        tl.add(e.worker, e.name, isp_s + e.start, e.duration, e.kind)
    return tl


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    raw = raw_frame(args.seed)
    g = build_paper_graph(PAPER_NETS["cnn10"], batch=1)
    run_frame(raw, g, device)           # warm-up: kernels built, params sent
    out = run_frame(raw, g, device)
    print(f"ISP ({FRAME_HW[0]}x{FRAME_HW[1]} raw -> RGB + "
          f"{DNN_HW[0]}x{DNN_HW[1]} DNN input) on {device}: "
          f"{out['isp_ms']:.3f} ms")
    print(f"CNN10 inference: {out['cnn_ms']:.3f} ms, class={out['cls']}")
    print(f"frame time: {out['frame_ms']:.3f} ms - "
          f"{'MEETS' if out['meets_budget'] else 'MISSES'} the "
          f"{BUDGET_MS:g} ms budget")
    return out


if __name__ == "__main__":
    main()
