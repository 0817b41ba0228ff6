"""Camera-powered deep learning pipeline (paper §V): raw 720p Bayer frame ->
ISP -> downsample -> CNN10 classifier, against a 33 ms frame budget, with
the Fig 19-style execution timeline.

The port's counterpart of ``examples/camera_pipeline.py``.  The measured
half is ``repro_torch.launch.camera.run_frame`` on the card: the ISP in
plain torch, CNN10 through the graph executor (every convolution and FC
layer on the NVDLA matmul kernel), each timed on the host clock with the
device synced.  As in the reference, only the ISP is warmed, and CNN10 is
timed on its first run, which copies its params to the device (and, first
in a process, loads the kernel).  The simulated half goes through the sweep
layer (``repro_torch.sim.sweep``): one memoized lowering of CNN10, priced
under an 8-accelerator SoC whose accelerators take the engine's defaults,
one H100's constants, and composed after the measured ISP by
``launch.camera.frame_timeline``.

  PYTHONPATH=src python examples_torch/camera_pipeline.py
  PYTHONPATH=src python examples_torch/camera_pipeline.py --device cpu
"""
import argparse

import torch

from repro_torch.apps.camera import camera_pipeline
from repro_torch.apps.paper_graphs import build_paper_graph
from repro_torch.configs.paper_nets import PAPER_NETS
from repro_torch.core.device import resolve_device
from repro_torch.launch.camera import (BUDGET_MS, DNN_HW, frame_timeline,
                                       raw_frame, run_frame)
from repro_torch.sim import engine
from repro_torch.sim.sweep import lower_graph


def main(argv=None):
    """Returns ``run_frame``'s dict, with the frame ``timeline``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    where = "CPU" if device.type == "cpu" else "the card"

    raw = raw_frame(0)
    camera_pipeline(torch.as_tensor(raw).to(device), dnn_hw=DNN_HW)  # warm
    net = PAPER_NETS["cnn10"]
    g = build_paper_graph(net, batch=1)
    out = run_frame(raw, g, device)
    print(f"ISP (720p raw -> RGB + 32x32 DNN input): {out['isp_ms']:.1f} ms")
    print(f"CNN10 inference: {out['cnn_ms']:.1f} ms, class={out['cls']}")

    # simulated accelerator execution + combined frame timeline (Fig 19):
    # the CNN10 program under an 8-accelerator SoC, appended after the
    # MEASURED ISP time (the modeled-ISP composition lives in frame_sweep;
    # using it here would count the ISP twice)
    dnn_prog = lower_graph(g, batch=1, max_tile_elems=16384)
    cfg = engine.EngineConfig(n_workers=8, interface="acp", hbm_ports=4)
    tl = out["timeline"] = frame_timeline(dnn_prog, out["isp_ms"] * 1e-3,
                                          cfg)
    total_ms = tl.makespan * 1e3
    verdict = "MEETS" if total_ms < BUDGET_MS else "MISSES"
    print(f"\nframe time (ISP on {where} + CNN10 on 8 accelerators): "
          f"{total_ms:.1f} ms — {verdict} the {BUDGET_MS:g} ms budget")
    print(tl.ascii(width=64))
    return out


if __name__ == "__main__":
    main()
