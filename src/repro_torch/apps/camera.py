"""Camera ISP pipeline (paper §V) on torch, on one device.

Stages, as the JAX package's ``repro/apps/camera.py`` runs them: hot-pixel
suppression, deinterleave (Bayer planes), demosaic (bilinear), white
balance, color correction, gamma, sharpen, and downsample to the DNN input
size.  Every stage is plain float32 torch: the stencils are sums of shifted
frames, so no stage reaches cuDNN (whose float32 convolutions run in TF32 by
default) or a matrix-product library.

Raw input: (H, W) Bayer-mosaic (RGGB) sensor values in [0, 1), H and W even.

The simulator's view of the frame: ``camera_program`` prices the ISP's
stages as ``CostedOp``s, composable with a net's program
(``camera_program(...).then(graph.program())``), and ``camera_soc`` is the
camera SoC topology (a frontend device feeding the NN accelerators).
``frame_sweep`` and ``soc_frame_sweep`` run the paper's accelerator-size
and camera-SoC studies over a config or topology grid through
``repro_torch.sim.sweep``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _convolve2d_same(x, k):
    """``jax.scipy.signal.convolve2d(x, k, mode="same")`` for a 2-d ``x``
    and a small kernel ``k`` (nested lists): a true convolution (the kernel
    flipped) over zero padding, the output centred on the full one."""
    kh, kw = len(k), len(k[0])
    ch, cw = (kh - 1) // 2, (kw - 1) // 2
    H, W = x.shape
    p = F.pad(x, (kw - 1 - cw, cw, kh - 1 - ch, ch))
    out = torch.zeros_like(x)
    for a in range(kh):
        for b in range(kw):
            tap = k[kh - 1 - a][kw - 1 - b]
            if tap:
                out = out + tap * p[a:a + H, b:b + W]
    return out


def hot_pixel_suppression(raw):
    """Clamp each pixel to the max/min of its 4 same-color neighbours."""
    p = F.pad(raw[None, None], (2, 2, 2, 2), mode="replicate")[0, 0]
    n = torch.stack([p[:-4, 2:-2], p[4:, 2:-2], p[2:-2, :-4], p[2:-2, 4:]])
    return torch.minimum(torch.maximum(raw, n.amin(0)), n.amax(0))


def deinterleave(raw):
    """RGGB Bayer -> 4 half-res planes (r, g0, g1, b)."""
    return (raw[0::2, 0::2], raw[0::2, 1::2], raw[1::2, 0::2],
            raw[1::2, 1::2])


_BILINEAR = [[0.0625, 0.125, 0.0625], [0.125, 0.25, 0.125],
             [0.0625, 0.125, 0.0625]]   # k.T @ k with k = [0.25, 0.5, 0.25]


def demosaic(r, g0, g1, b):
    """Bilinear demosaic to full-res RGB (half-res planes upsampled)."""
    def up(x):
        x2 = x.repeat_interleave(2, 0).repeat_interleave(2, 1)
        return _convolve2d_same(x2, _BILINEAR) \
            / _convolve2d_same(torch.ones_like(x2), _BILINEAR)
    g = (up(g0) + up(g1)) * 0.5
    return torch.stack([up(r), g, up(b)], dim=-1)


def white_balance(rgb, gains=(2.0, 1.0, 1.6)):
    return rgb * torch.tensor(gains, dtype=rgb.dtype, device=rgb.device)


_CCM = ((1.6, -0.4, -0.2),
        (-0.3, 1.5, -0.2),
        (-0.1, -0.5, 1.6))


def color_correct(rgb):
    """``clip(rgb @ ccm.T, 0, 1)``, as a weighted sum over the channels."""
    ccm = torch.tensor(_CCM, dtype=rgb.dtype, device=rgb.device)
    return torch.clamp((rgb[..., None, :] * ccm).sum(-1), 0.0, 1.0)


def gamma(rgb, g=2.2):
    return torch.pow(torch.clamp(rgb, 1e-6, 1.0), 1.0 / g)


_SHARPEN = [[0, -1.0, 0], [-1.0, 5.0, -1.0], [0, -1.0, 0]]


def sharpen(rgb, amount=0.6):
    sharp = torch.stack([_convolve2d_same(rgb[..., i], _SHARPEN)
                         for i in range(3)], dim=-1)
    return torch.clamp((1 - amount) * rgb + amount * sharp, 0.0, 1.0)


def downsample(rgb, out_hw):
    H, W, _ = rgb.shape
    oh, ow = out_hw
    fh, fw = H // oh, W // ow
    return rgb[:oh * fh, :ow * fw].reshape(oh, fh, ow, fw, 3).mean((1, 3))


def camera_pipeline(raw, dnn_hw=(32, 32)):
    """Full ISP on ``raw``'s device: raw Bayer (H, W) float32 -> RGB frame
    (H, W, 3) + the downsampled DNN input (dnn_hw[0], dnn_hw[1], 3)."""
    raw = hot_pixel_suppression(raw)
    planes = deinterleave(raw)
    rgb = demosaic(*planes)
    rgb = white_balance(rgb)
    rgb = color_correct(rgb)
    rgb = gamma(rgb)
    rgb = sharpen(rgb)
    return rgb, downsample(rgb, dnn_hw)


# ---------------------------------------------------------------------------
# the simulator's view of the frame (as repro/apps/camera.py)


def camera_program(hw=(720, 1280), dnn_hw=(32, 32), device_class="cpu"):
    """Per-stage (flops, bytes) costs of the ISP at the given raw size.

    ``device_class`` places the stages on the SoC frontend (``"cpu"`` |
    ``"dsp"``); flat configs have no such device and fall back to the
    accelerator pool."""
    from repro_torch.sim.ir import BYTES_PER_ELEM, CostedOp, Program

    H, W = hw
    px = float(H * W)
    rgb = 3.0 * px
    # (name, flops, elems_in, elems_out); flops from the stage's arithmetic:
    # stencil stages count kernel taps, pointwise stages 1-2 ops/elem
    stages = [
        ("hot_pixel", 6.0 * px, px, px),            # 4-neighbour min/max+clip
        ("deinterleave", px, px, px),               # pure data movement
        ("demosaic", 2.0 * 9.0 * rgb, px, rgb),     # bilinear 3x3 upsample
        ("white_balance", rgb, rgb, rgb),
        ("color_correct", 2.0 * 9.0 * px, rgb, rgb),  # 3x3 CCM per pixel
        ("gamma", 2.0 * rgb, rgb, rgb),             # pow: transcendental
        ("sharpen", 2.0 * 9.0 * rgb, rgb, rgb),     # 3x3 stencil per channel
        ("downsample", rgb, rgb, 3.0 * dnn_hw[0] * dnn_hw[1]),
    ]
    ops = []
    prev = None
    for name, flops, ein, eout in stages:
        ops.append(CostedOp(
            name=f"isp/{name}",
            flops=flops,
            bytes_in=BYTES_PER_ELEM * ein,
            bytes_out=BYTES_PER_ELEM * eout,
            transcendentals=eout if name == "gamma" else 0.0,
            deps=(prev,) if prev else (),
            phase="isp",
            device_class=device_class))
        prev = f"isp/{name}"
    return Program(ops, name="camera_isp", source="custom",
                   meta={"hw": hw, "dnn_hw": dnn_hw,
                         "device_class": device_class})


# frontend peak flops per kind, embedded-SoC scale: an in-order CPU
# cluster vs a vector DSP (the camera ISP is stencil/pointwise code both
# can run; the DSP is the paper's specialized-frontend alternative).
# SMAUG's modeled SoC, the JAX package's values: not the H100's.
FRONTEND_PEAK = {"cpu": 5e10, "dsp": 2e11}


def camera_soc(n_accels=4, frontend="cpu", *, link_ports=4.0,
               frontend_peak_flops=None, frontend_interface="acp",
               accel_peak_flops=None, accel_datapath_scale=None, name=""):
    """A camera SoC topology: one ``frontend`` device (``"cpu"`` |
    ``"dsp"``) feeding ``n_accels`` NN accelerators over one shared HBM
    link with ``link_ports`` ports — the object SMAUG's camera-SoC-tuning
    study sweeps.  The frontend defaults to the fused/resident ``acp``
    interface (ISP stencils stream through on-chip line buffers, Halide
    style) while the accelerators inherit the flat config's interface and
    stream their tiles over the shared link.  Accelerator fields left
    ``None`` inherit the flat ``EngineConfig`` (peak flops, datapath
    scale), so a bare ``EngineConfig(topology=camera_soc())`` puts H100
    accelerators beside the modeled frontend."""
    from repro_torch.sim.hw import Device, Link, SoCTopology

    fpeak = (FRONTEND_PEAK.get(frontend, FRONTEND_PEAK["cpu"])
             if frontend_peak_flops is None else frontend_peak_flops)
    devices = (Device(f"{frontend}0", kind=frontend, peak_flops=fpeak,
                      interface=frontend_interface),)
    devices += tuple(Device(f"acc{i}", peak_flops=accel_peak_flops,
                            datapath_scale=accel_datapath_scale)
                     for i in range(n_accels))
    return SoCTopology(
        devices=devices, links=(Link("hbm", ports=link_ports),),
        name=name or f"{frontend}+{n_accels}acc/p{link_ports:g}")


def frame_sweep(dnn_program, configs, hw=(720, 1280), dnn_hw=(32, 32),
                name="frame", frontend_class="cpu"):
    """Whole-frame design-space sweep: ISP program composed with the DNN
    program, evaluated under every SoC config through the batched
    ``repro_torch.sim.sweep`` layer (one lowering + shared dependency plan).

    Returns ``(frame_program, [EngineResult per config])`` — the Fig 19/20
    accelerator-size study is one call with a PE-scaled config grid, and
    the camera-SoC-tuning study is the same call with topology-bearing
    configs (``EngineConfig(topology=camera_soc(...))``), where the ISP
    stages land on the frontend device and the DNN tiles on the
    accelerators in ONE simulated execution.
    """
    from repro_torch.sim.sweep import sweep

    frame = camera_program(hw, dnn_hw, device_class=frontend_class) \
        .then(dnn_program, name=name)
    return frame, sweep(frame, configs)


def soc_frame_sweep(dnn_program, topologies, base_config=None,
                    hw=(720, 1280), dnn_hw=(32, 32), name="frame"):
    """Camera-SoC-tuning sweep over a grid of ``camera_soc`` topologies.

    The frontend class of each composed frame program follows the
    topology's frontend device kind, so a ``dsp`` SoC runs the ISP on its
    DSP.  Topologies sharing a frontend kind share one composed frame
    program, so the whole group goes through ``sweep`` as one batch (one
    lowering + one dependency plan per kind, not per cell).  Returns
    ``[(topology, frame_program, EngineResult)]`` in grid order — one
    heterogeneous simulated execution per SoC.  ``base_config`` defaults
    to ``EngineConfig()``: accelerators at one H100's rates."""
    import dataclasses

    from repro_torch.sim.engine import EngineConfig
    from repro_torch.sim.sweep import sweep

    base = base_config if base_config is not None else EngineConfig()
    topologies = list(topologies)
    kinds = [next((d.kind for d in t.devices if d.kind in ("cpu", "dsp")),
                  "cpu") for t in topologies]
    out = [None] * len(topologies)
    for kind in dict.fromkeys(kinds):           # unique, grid order
        idxs = [i for i, k in enumerate(kinds) if k == kind]
        frame = camera_program(hw, dnn_hw, device_class=kind) \
            .then(dnn_program, name=f"{name}/{kind}")
        results = sweep(frame, [
            dataclasses.replace(base, topology=topologies[i])
            for i in idxs])
        for i, res in zip(idxs, results):
            out[i] = (topologies[i], frame, res)
    return out
