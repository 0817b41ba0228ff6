"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. identify the card (torch and nvidia-smi: name and power limit);
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels``, and count the selective scan's SASS instructions per
   (thread, timestep) in its loop over time (``cuobjdump -sass``);
3. hold the flash kernel against its plain PyTorch version on the card, at
   the ``tests/test_kernels.py`` shapes, the serving shapes, every other
   head dim (16, 32 and 96 in padded TMA boxes, phi3_mini_3_8b's prefill
   among them), ragged lengths, lengths below one tile and window edges,
   in float32 and bf16, in the variant its rule names
   (``flash_attention.variant``) and beside it the one it replaced (bf16
   ``mma.sync`` beside ``wgmma``, float32 ``fma`` beside ``tf32x3``); then
   a 6-layer cut of
   gemma3_1b at full width served on the card against the same params on the
   CPU (plain path) on one small input;
4. serve gemma3_1b at full width (26 layers, random params from a seed):
   8 requests, batch 4, prompt 1024, 32 new tokens, through
   ``repro_torch.launch.serve.serve``, counting the kernel's launches by
   variant: all of them on the Hopper variant;
5. time both bf16 variants at the serving shapes against the plain version
   and, as a yardstick only, ``F.scaled_dot_product_attention``, beside the
   bound, with each wrapper's host time per call;
6. profile one prefill batch and 8 decode steps with ``torch.profiler``:
   device time by kernel and the device's busy share of the wall time;
7. hold the matmul and selective-scan kernels against their plain versions
   on the card, in float32 and bf16, at the ``tests/test_kernels.py`` shapes
   and tolerances, at ragged shapes, at M and N off the Hopper tile and K
   over several turns of its ring, and at every shape of the calibration's
   ``"model"`` grid, the matmul in the variant the shape rule names and
   those beside it (``_BESIDE``: ``mma.sync`` beside bf16's ``wgmma``; the
   FMA kernel beside float32's ``tf32x3`` and ``stream``); then all three
   kernels at every shape of the
   ``"model"`` and ``"full"`` grids on the calibration's own float32 inputs;
8. time them at the ``"model"`` grid's shapes (the matmul in the same
   variants, float32 flash in ``tf32x3`` and ``fma``) against their plain
   versions, the library yardstick (``torch.matmul``; SDPA in float32; no PyTorch call
   computes a selective scan) and each variant's bound, with each
   wrapper's host time per call, and split a matmul ``tf32x3`` call's
   device time between its split pass and its product with
   ``torch.profiler``;
9. run the calibration loop (``repro_torch.kernels.calibrate.measure``) on
   the ``"model"`` and ``"full"`` grids, counting the three kernels'
   launches by variant (float32 matmul and flash as their rules name
   them: flash all ``tf32x3``), and print each kernel's fit;
10. run the paper's Table-III networks (``repro_torch.core.graph``, params
   from a seed) at batch 1 and 64 on the card and on the CPU (plain path)
   with the same params and input: every convolution and FC node, fed the
   card's inputs, at the float32 matmul tolerance; the logits at rtol 5e-4,
   atol 5e-4 max|CPU logits|; the matmul's launches by variant along each
   forward as the float32 rule names them (``GRAPH_LAUNCHES``);
11. time each net's forward (median wall ms of 20 synchronized runs,
   images/s), its products on the matmul kernel beside their bound and
   ``torch.matmul`` on the same operands, and at each batch its device
   time, split between the matmul kernels and the rest, over the wall time
   (``torch.profiler``): the paper's accelerator-versus-framework
   breakdown;
12. run one camera frame (``repro_torch.launch.camera.run_frame``: a seeded
   720x1280 raw frame, the ISP, CNN10 at batch 1) on the card against the
   CPU (RGB frame and DNN input at atol 1e-5), counting its matmul
   launches, and time it against the 33 ms frame budget;
13. hold the selective scan with its state (``h0`` in, h_S out) against its
   plain version on the card, float32 at ``SCAN_TOL``: y and h_S from zeros
   and from a random h0 at every ``SCAN_CASES`` shape and at
   falcon_mamba_7b's serving shape (4, 1024, 8192, 16); and a prompt split
   in two (the first part, then the rest from its h_S) against one call;
14. run falcon_mamba_7b cut to 2 layers at full width on the card against
   the same params on the CPU (plain path): 2 prompts of 300 tokens (off
   the kernel's 32-step chunk), the prefill logits, the ``conv`` and
   ``ssm`` caches and 2 decode steps fed the CPU's greedy tokens at
   ``BF16_TOL``, with exactly 2 scan launches;
15. serve falcon_mamba_7b at full width and depth (64 Mamba1 layers, bf16
   params from a seed made on the card; gemma3_1b's are freed first): 8
   requests, batch 4, prompt 1024, 32 new tokens, through ``serve``, with
   exactly 64 x 2 = 128 scan launches and every logit finite;
16. profile one falcon_mamba_7b prefill batch and 8 decode steps as in
   phase 6, with the scan's share of the prefill's device time;
17. time the scan at the serving shape with no state, with h_S out (what
   prefill runs) and with h0 in and h_S out, beside its bound (the state's
   bytes included) and its plain version;
18. run phi3_mini_3_8b cut to 4 layers at full width (d_model 3072, 32
   heads of head dim 96, MHA) on the card against the same params on the
   CPU (plain path): 2 prompts of 300 tokens, the prefill logits, the KV
   cache and 2 decode steps at ``BF16_TOL``, with exactly 4 flash launches
   of the variant the rule names at D = 96;
19. serve phi3_mini_3_8b at full width and depth (32 layers, bf16 params
   from a seed made on the card) under ``SERVE``, with exactly 32 x 2 = 64
   flash launches, all of that variant, and every logit finite;
20. profile one phi3_mini_3_8b prefill batch and 8 decode steps as in
   phase 6, with the flash kernel's share of the prefill's device time;
21. time both types' variants at phi3_mini_3_8b's prefill shape at head
   dims 16, 32 and 96, and float32 at the ``"full"`` grid's attention
   shapes of those head dims, beside the plain version, SDPA and the bound
   (whose exponential term decides bf16 at D <= 32);
22. price each Table-III net at batch 1 and 64, not cut, with the port's
   simulator (``repro_torch.sim``): ``Graph.program`` at the default
   16,384-element tiles and at one tile a node, run on one H100
   (``EngineConfig()``: one worker, the hbm interface, the H100's
   constants) under the roofline, under the measured table of phase 9's
   ``model`` grid (``calibrate.table_backend``) and under the table with
   the matmul wrapper's host time a call (phase 8) charged a dispatch;
   each price (makespan, accelerator / transfer / host shares, op count,
   the engine's CPU time) beside phase 11's wall, device and matmul ms, and
   price over measured.  Asserts: every makespan finite and positive, the
   op count the sum of the chosen tilings' tile counts, the table
   reproducing its samples, and no kernel launched.  First, one small
   device copy's time (the tiling target's per-copy latency);
23. price the camera frame (the ISP's stages at 720x1280 on the
   accelerator, then CNN10 at batch 1) and its two parts under the same
   three backends beside phase 12's ms, and once on ``camera_soc()`` (ISP
   on the frontend CPU, CNN10 on 4 accelerators at the H100's rates).

Kernel times are CUDA events around back-to-back calls queued behind a
device-side wait (``torch.cuda._sleep``) that outlasts their enqueue, so
that they are the card's time and not the wrapper's host time.  The line
before the last is a JSON ``kernels`` summary (flash's launches by path:
gemma3_1b serving, phi3_mini_3_8b serving, calibration, and its times at
head dims 16, 32 and 96; the scan's entry: its launches by path,
calibration and falcon_mamba_7b serving, and its times at the serving
shape); the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import sim  # noqa: E402
from repro_torch.apps.camera import camera_program, camera_soc  # noqa: E402
from repro_torch.apps.paper_graphs import build_paper_graph  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.paper_nets import PAPER_NETS  # noqa: E402
from repro_torch.convert import to_device  # noqa: E402
from repro_torch.core import graph_ops  # noqa: E402
from repro_torch.kernels import _build, calibrate, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import nvdla_matmul as mm  # noqa: E402
from repro_torch.launch import camera  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.step import (greedy, make_decode_step,  # noqa: E402
                                    make_prefill_step)
from repro_torch.core.tensor import TensorSpec  # noqa: E402
from repro_torch.core.tiling import H100 as H100_TILING  # noqa: E402
from repro_torch.core.tiling import choose_tiling  # noqa: E402
from repro_torch.sim import hw  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}   # tests/test_kernels.py
BF16_TOL = 2e-2              # tests/test_torch_serve.py
KERNEL_CASES = [  # B, H, Hkv, S, D, causal, window
    (1, 2, 2, 128, 32, True, 0),            # tests/test_kernels.py
    (2, 4, 2, 128, 64, True, 0),
    (1, 2, 1, 256, 32, True, 48),
    (1, 2, 2, 128, 32, False, 0),
    (4, 4, 1, 1024, 256, True, 512),        # gemma3_1b local layer
    (4, 4, 1, 1024, 256, True, 0),          # gemma3_1b global layer
    (4, 4, 1, 1000, 256, True, 512),        # ragged S
    (4, 4, 1, 1024, 64, True, 0),           # the Hopper variant's other Ds
    (4, 4, 1, 1024, 128, True, 512),
    (2, 4, 2, 1000, 128, True, 0),          # ragged S, GQA
    (1, 4, 1, 77, 256, True, 0),            # S below two tiles
    (1, 4, 1, 77, 64, True, 30),
    (2, 4, 1, 1024, 256, True, 64),         # window of one tile
    (1, 4, 1, 1000, 128, True, 100),        # window off the tile grid
    (1, 2, 1, 300, 256, False, 0),          # no causal mask
    (1, 2, 1, 256, 64, False, 70),          # window without causal
    (4, 32, 32, 1024, 96, True, 0),         # phi3_mini_3_8b prefill
    (4, 32, 32, 1024, 16, True, 0),         # padded boxes: D 16 and 32
    (4, 32, 32, 1024, 32, True, 0),
    (2, 4, 2, 1000, 96, True, 0),           # ragged S, GQA
    (1, 4, 1, 77, 16, True, 30),            # S below two tiles, window
    (1, 4, 2, 50, 96, True, 0),             # S below one tile
    (1, 2, 1, 300, 16, False, 0),           # no causal mask
    (1, 2, 2, 256, 96, False, 70),          # window without causal
    (2, 4, 1, 1000, 32, True, 100),         # window off the tile grid
]
SERVE = dict(requests=8, batch=4, prompt_len=1024, max_new=32)
# the head dims off whole 128-byte TMA boxes, and phi3_mini_3_8b's prefill
# attention in SERVE at each (causal): B, H, Hkv, S, D
SMALL_D = (16, 32, 96)
PHI3_PREFILL = [(SERVE["batch"], get_config("phi3_mini_3_8b").n_heads,
                 get_config("phi3_mini_3_8b").n_kv_heads, SERVE["prompt_len"],
                 D) for D in SMALL_D]
# tests/test_kernels.py tolerances: matmul rtol tol, atol tol * sqrt(K);
# scan rtol tol, atol 4 tol
MM_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SCAN_TOL = {torch.float32: 2e-4, torch.bfloat16: 8e-2}
MM_CASES = [  # M, N, K
    (128, 128, 128), (256, 128, 384),       # tests/test_kernels.py
    (512, 256, 256), (128, 512, 640),
    (100, 72, 200), (17, 130, 33), (4, 6912, 1152),      # ragged edges
    (200, 6912, 1152), (4100, 1032, 1152),   # M, N off the Hopper tile
    (512, 1024, 4096),                       # K: 64 turns of a 4-stage ring
    (784, 32, 9), (1024, 32, 27), (1024, 64, 27),   # graph path: K under
    (1024, 192, 27),                                # one 32-wide TF32 row
    (64, 10, 512), (64, 100, 300),           # logits: tf32x3 at batch 64,
    (1, 10, 512), (1, 100, 300),             # stream at batch 1
    (1, 10, 6272),                           # stream, N % 4 != 0, large K
] + list(calibrate.MODEL_GRIDS["matmul"])
SCAN_CASES = [  # b, S, d, N
    (1, 32, 16, 8), (2, 64, 32, 16),        # tests/test_kernels.py
    (1, 128, 64, 8),
    (1, 77, 40, 16), (3, 200, 130, 8),                   # ragged S and d
] + list(calibrate.MODEL_GRIDS["mamba"])
CAL_TOL = {"matmul": MM_TOL[torch.float32], "attention": TOL[torch.float32],
           "mamba": SCAN_TOL[torch.float32]}   # calibration runs float32
CALIBRATION = (("model", 3), ("full", 3))   # grid, repeat
GRAPH_BATCHES = (1, 64)
# the matmul's launches by variant along one forward of each Table-III net,
# as nvdla_matmul.variant's float32 rule names them for the nets' conv and
# FC shapes (M > 16 rows: tf32x3, else stream): {net: {batch: counts}}
GRAPH_LAUNCHES = {
    "minerva": {1: {"stream": 4}, 64: {"tf32x3": 4}},
    "lenet5": {1: {"tf32x3": 2, "stream": 2}, 64: {"tf32x3": 4}},
    "cnn10": {1: {"tf32x3": 4, "stream": 2}, 64: {"tf32x3": 6}},
    "vgg16": {1: {"tf32x3": 7, "stream": 5}, 64: {"tf32x3": 12}},
    "elu16": {1: {"tf32x3": 5, "stream": 6}, 64: {"tf32x3": 11}},
}
# logits, card against CPU: rtol, and atol as a share of max |CPU logits|;
# looser than a node's because rounding compounds over up to 13 layers and
# batch norm divides by a batch std (vgg16 at batch 64 reaches 1.4e-4)
GRAPH_TOL = 5e-4
GRAPH_RUNS = 20           # timed forwards (and camera frames) a median takes
ISP_TOL = 1e-5            # RGB frame and DNN input, card against CPU
FALCON_CUT = 2            # layers of the full-width card-against-CPU check
FALCON_PROMPTS = (2, 300)  # prompts x tokens: 300 is off the 32-step chunk
PHI3_CUT = 4               # layers of phi3_mini_3_8b's card-against-CPU check
PHI3_PROMPTS = (2, 300)    # prompts x tokens: 300 is off the 64-row tile


def log(*args):
    print(*args, flush=True)


def rand_qkv(B, H, Hkv, S, D, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


def identify():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {name}; count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")
    return name, smi


def build_kernels():
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
        f"into {_build.BUILD_DIR}")
    for name, path in libs.items():
        log_path = path.with_suffix(".log")
        if log_path.exists():   # ptxas report of a fresh build, by kernel
            for entry in log_path.read_text().split("Compiling entry")[1:]:
                kernel = entry.split("'")[1]
                kernel = kernel[kernel.find("GLOBAL__N_"):][-72:]
                used = [line.split(":", 1)[-1].strip()
                        for line in entry.splitlines()
                        if "Used" in line or "spill" in line]
                log(f"  {name} ...{kernel}: {'; '.join(used)}")


def _check(name, out, expect, rtol, atol):
    """assert_allclose's rule, |out - expect| <= atol + rtol |expect|, on the
    card; returns the largest error."""
    diff = (out.float() - expect.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= atol + rtol * expect.float().abs()).all()) \
        and bool(torch.isfinite(out.float()).all())
    log(f"{name}: max_abs_err {err:.3e} (rtol {rtol}, atol {atol:.3g}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name} mismatch: {err}")
    return err


# the variants held and timed beside the one a shape rule names: the older
# kernels it replaced
_BESIDE = {(fa, "wgmma"): ["mma_sync"], (fa, "tf32x3"): ["fma"],
           (mm, "wgmma"): ["mma_sync"], (mm, "tf32x3"): ["fma"],
           (mm, "stream"): ["fma"]}


def _variants(kernel, dtype, *shape):
    """The variant that the shape rule of ``kernel`` (the module ``fa`` or
    ``mm``) names, and those ``_BESIDE`` it."""
    name = kernel.variant(*shape, dtype)
    return [name] + _BESIDE.get((kernel, name), [])


def _ran(fn, name, call):
    """``call()`` after checking that it launched the kernel once, in the
    variant ``name``."""
    before = dict(fn.launches_by_variant)
    out = call()
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in fn.launches_by_variant.items()
           if n != before[k]}
    if ran != {name: 1}:
        raise AssertionError(f"expected one {name} launch, got {ran}")
    return out


def check_kernel():
    """Every case in fp32 and bf16, kernel vs plain version on the card, in
    each variant of ``_variants``.  Returns the largest error at the serving
    shapes in bf16 of the variant serving runs, and the largest error of
    float32 ``tf32x3``."""
    worst, worst_f32 = 0.0, 0.0
    for case in KERNEL_CASES:
        B, H, Hkv, S, D, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = rand_qkv(B, H, Hkv, S, D, dtype)
            expect = ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window)
            for name in _variants(fa, dtype, D):
                out = _ran(fa.flash_attention, name,
                           lambda: fa.flash_attention(
                               q, k, v, causal=causal, window=window,
                               kernel=name))
                err = _check(f"kernel {name} vs plain {case} {dtype}", out,
                             expect, TOL[dtype], TOL[dtype])
                if D == 256 and name == fa.variant(D, dtype) == "wgmma":
                    worst = max(worst, err)
                if name == "tf32x3":
                    worst_f32 = max(worst_f32, err)
    return worst, worst_f32


def _bf16_close(name, out, expect):
    out, expect = out.float().cpu(), expect.float().cpu()
    err = (out - expect).abs().max().item()
    scale = expect.abs().max().item()
    ok = bool(((out - expect).abs()
               <= BF16_TOL * scale + BF16_TOL * expect.abs()).all())
    log(f"  {name}: max_abs_err {err:.3e} (max |ref| {scale:.3e}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: card and CPU disagree ({err})")


def check_model_against_cpu(arch="gemma3_1b", n_layers=6, prompts=(2, 600)):
    """``arch`` cut to ``n_layers`` at full width, ``prompts`` (count,
    tokens): prefill logits and cache plus 2 teacher-forced decode steps on
    the card (through the kernel, once a layer, in the variant the rule
    names) against the CPU (plain path).  gemma3_1b: 6 layers (5 local, 1
    global), prompt 600 (> window 512)."""
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    cpu = T.init_params(cfg, seed=1, device="cpu")
    gpu = to_device(cpu, "cuda")
    B, S = prompts
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    log(f"model check: {cfg.name} cut to {cfg.n_layers} layers at d_model "
        f"{cfg.d_model}, head dim {cfg.resolved_head_dim}, tokens "
        f"{tuple(tokens.shape)}, card vs CPU")
    name = fa.variant(cfg.resolved_head_dim, torch.bfloat16)
    before = fa.flash_attention.launches_by_variant[name]
    out, toks = {}, []
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        logits, cache = T.prefill_forward(cfg, params,
                                          {"tokens": tokens.to(dev)},
                                          max_seq=S + 2)
        steps = [logits]
        for i in range(2):   # both sides take the CPU's greedy tokens
            if dev == "cpu":
                toks.append(torch.argmax(logits[:, -1], -1, keepdim=True))
            logits, cache = T.decode_forward(cfg, params, cache,
                                             toks[i].to(dev), S + i)
            steps.append(logits)
        out[dev] = steps + [cache]
    ran = fa.flash_attention.launches_by_variant[name] - before
    log(f"  flash launches on the card: {ran} of {name} (expected "
        f"{cfg.n_layers})")
    if ran != cfg.n_layers:
        raise AssertionError("model check did not go through the kernel")
    for i in range(3):
        _bf16_close(f"logits step {i}", out["cuda"][i], out["cpu"][i])
    for key in ("k", "v"):
        _bf16_close(f"cache {key}", out["cuda"][3][key], out["cpu"][3][key])


def serve_full(arch="gemma3_1b"):
    """``arch`` at full width and depth through ``serve``, params from a
    seed made on the card; the flash counts are set to 0 just before and
    read just after: one launch a layer a prefill batch, all of the variant
    the rule names at its head dim.  Returns the config, the params, the
    launches and the launches by variant."""
    cfg = get_config(arch)
    log(f"serve: {cfg.name} full width, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} of head dim "
        f"{cfg.resolved_head_dim}, vocab {cfg.vocab}, "
        f"{cfg.param_count() / 1e9:.3f} B params; {SERVE}")
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    stats = serve(cfg, device="cuda", seed=0, params=params, log=log, **SERVE)
    launches = fa.flash_attention.launches
    by_variant = dict(fa.flash_attention.launches_by_variant)
    expect = cfg.n_layers * stats["batches"]
    name = fa.variant(cfg.resolved_head_dim, torch.bfloat16)
    log(f"flash_attention launches in serving: {launches}, by variant "
        f"{by_variant} (expected {cfg.n_layers} layers x {stats['batches']} "
        f"prefill batches = {expect}, all {name})")
    if launches != expect or by_variant[name] != expect:
        raise AssertionError(f"{by_variant} flash launches, expected "
                             f"{expect} of {name}")
    _log_serving(stats)
    return cfg, params, launches, by_variant


def _log_serving(stats):
    """Checks a ``serve`` call of ``SERVE`` (every request served, every
    logit finite) and logs its prefill ms a batch, decode ms a step, tok/s
    and peak device memory."""
    if not stats["finite"]:
        raise AssertionError("non-finite logits")
    if stats["requests"] != SERVE["requests"]:
        raise AssertionError(f"served {stats['requests']} requests")
    per_tok = [1e3 * s / stats["decode_steps"] for s in stats["decode_s"]]
    tokens = stats["requests"] * SERVE["max_new"]
    log(f"prefill ms per batch: "
        f"{[round(1e3 * s, 3) for s in stats['prefill_s']]}")
    log(f"decode ms per token step (batch {SERVE['batch']}): "
        f"{[round(t, 3) for t in per_tok]}")
    log(f"aggregate {tokens / stats['seconds']:.1f} tok/s "
        f"({tokens} tokens in {stats['seconds']:.3f} s)")
    log(f"max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def cuda_ms(fn, iters, hold=True):
    """Device ms a call: CUDA events around ``iters`` back-to-back calls,
    after 3 warm-ups.  With ``hold``, the start event waits behind a
    device-side sleep that outlasts the calls' enqueue (checked: the sleep
    must still be running when the last call is queued, else it is doubled
    and the run taken again), so the card runs them back to back whatever
    the host's time.  The plain versions are timed without: their thousands
    of small launches would fill the launch queue behind the sleep."""
    for _ in range(3):
        fn()
    cycles = 2_000_000
    while True:
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if hold:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time or not hold:
            return start.elapsed_time(end) / iters
        if cycles > 1 << 34:
            raise RuntimeError("the calls' enqueue outlasted a 2^34-cycle "
                               "device-side sleep")
        cycles *= 2


def host_us(fn, calls=100):
    """Host us a call: ``perf_counter`` over ``calls`` enqueues (argument
    checks, allocation, tensor maps, the launch), the card left to run."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def bound(B, H, Hkv, S, D, window, dtype, variant):
    """Least time (ms) for the work these inputs need, the largest of three
    terms: live (q, k) pairs times 4 D operations at the variant's peak
    (bf16 on the tensor cores; float32 ``tf32x3`` as 3 passes of TF32 on
    the tensor cores, like ``matmul_bound``; float32 ``fma`` on the CUDA
    cores); one exponential a live pair at the special-function units'
    rate, as ``scan_bound`` counts them (it decides bf16 at D <= 32); q, k,
    v read once and o written once at the HBM rate.  Returns (ms, the term
    that sets it, {term: seconds}, operations, bytes)."""
    itemsize = torch.finfo(dtype).bits // 8
    live = B * H * sum(min(i + 1, window) if window else i + 1
                       for i in range(S))   # causal
    flops = 4 * D * live
    if variant == "tf32x3":
        flops, peak = 3 * flops, hw.PEAK_FLOPS_TF32
    else:
        peak = hw.PEAK_FLOPS if dtype == torch.float32 \
            else hw.PEAK_FLOPS_BF16
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * itemsize
    terms = {"operations": flops / peak, "exp": live / hw.EXP_RATE,
             "bytes": nbytes / hw.HBM_BW}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by, terms, flops, nbytes


def _sdpa(q, k, v, window):
    """The library yardstick: ``is_causal`` where there is no window, else
    the window as an explicit mask."""
    if not window:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    pos = torch.arange(q.shape[2], device="cuda")
    mask = (pos[:, None] >= pos[None, :]) \
        & ((pos[:, None] - pos[None, :]) < window)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def time_flash(B, H, Hkv, S, D, window, dtype, smi, seed=2):
    """Each variant of ``_variants`` at one shape: {variant: row} with the
    kernel's device ms and host us a call, the plain version's and SDPA's
    ms, and the bound."""
    q, k, v = rand_qkv(B, H, Hkv, S, D, dtype, seed=seed)
    lib = _sdpa(q, k, v, window)
    lib_err = (lib().float() - ref.flash_attention_ref(
        q, k, v, window=window).float()).abs().max().item()
    plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, window=window),
                    10, hold=False)
    lib_ms = cuda_ms(lib, 20)
    rows = {}
    for name in _variants(fa, dtype, D):
        def call():
            return fa.flash_attention(q, k, v, window=window, kernel=name)
        ms = cuda_ms(call, 20)
        b_ms, b_by, terms, flops, nbytes = bound(B, H, Hkv, S, D, window,
                                                 dtype, name)
        rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms,
                          bound_ms=b_ms, host_us=host_us(call),
                          bound_by="bytes" if b_by == "bytes"
                          else "operations", bound_term=b_by)
        log(f"flash_attention {name} B={B} H={H} Hkv={Hkv} S={S} D={D} "
            f"{dtype} window={window}: kernel {ms:.4f} ms (host "
            f"{rows[name]['host_us']:.1f} us a call), plain {plain:.4f} ms, "
            f"SDPA {lib_ms:.4f} ms (max_abs_err vs plain {lib_err:.2e}), "
            f"bound {b_ms:.4f} ms by {b_by} (ops "
            f"{1e3 * terms['operations']:.4f}, exp {1e3 * terms['exp']:.4f}, "
            f"bytes {1e3 * terms['bytes']:.4f} ms; {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.3f} MB), kernel {flops / ms / 1e9:.2f} TFLOP/s "
            f"= {100 * b_ms / ms:.2f}% of bound; card {smi}")
    return rows


def time_kernel(cfg, smi):
    """The serving shapes (bf16) by window: {window: {variant: row}}."""
    B, H, Hkv, S, D = SERVE["batch"], cfg.n_heads, cfg.n_kv_heads, \
        SERVE["prompt_len"], cfg.resolved_head_dim
    return {window: time_flash(B, H, Hkv, S, D, window, torch.bfloat16, smi)
            for window in (cfg.window, 0)}


def time_flash_small(smi):
    """The head dims 16, 32 and 96 (``SMALL_D``): both types at
    phi3_mini_3_8b's prefill shape at each, and float32 at the ``full``
    calibration grid's attention shapes of those head dims (what the
    calibration loop runs there), causal, no window: {(shape, type):
    {variant: row}}."""
    full = [s for s in calibrate.GRIDS["full"]["attention"]
            if s[-1] in SMALL_D]
    cases = [(shape, dtype) for shape in PHI3_PREFILL
             for dtype in (torch.bfloat16, torch.float32)] \
        + [(shape, torch.float32) for shape in full]
    return {(shape, dtype): time_flash(*shape, 0, dtype, smi)
            for shape, dtype in cases}


def time_flash_f32(smi):
    """The float32 kernel at the calibration's ``"model"`` attention shapes
    (causal, no window: what the calibration loop runs), ``tf32x3`` (the
    rule's variant there) beside ``fma``: {variant: [row by shape]}."""
    rows = {}
    for shape in calibrate.MODEL_GRIDS["attention"]:
        for name, row in time_flash(*shape, 0, torch.float32, smi).items():
            rows.setdefault(name, []).append(row)
    return rows


def profile_serving(cfg, params, smi, kernel=None):
    """Device time by kernel over one prefill batch and over 8 decode steps,
    and the device's busy share: summed kernel time over the wall time of
    the profiled region (the profiler's own host cost lengthens the wall
    time, so the share is a lower bound).  With ``kernel``, also the share
    of the device time taken by the kernels whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B, S, n = SERVE["batch"], SERVE["prompt_len"], 8
    tokens = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(3))
    prefill, decode = make_prefill_step(cfg, S + n), make_decode_step(cfg)
    for phase in ("prefill", "decode"):
        logits, cache = prefill(params, {"tokens": tokens})
        tok = greedy(logits)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                prefill(params, {"tokens": tokens})
            else:
                for i in range(n):
                    tok, cache, _ = decode(params, cache, tok, S + i)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        # device-side events only: a CPU op's device time repeats the
        # time of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        if not events:
            log(f"profile {phase}: no device time in the trace (not measured)")
            continue
        what = "1 batch" if phase == "prefill" else f"{n} steps"
        log(f"profile {phase} ({what}, B={B}): wall {wall_ms:.3f} ms, device "
            f"kernels {busy_ms:.3f} ms, busy {100 * busy_ms / wall_ms:.1f}%, "
            f"{sum(e.count for e in events)} device events; card {smi}")
        if kernel:
            k_ms = sum(e.self_device_time_total for e in events
                       if kernel in e.key) / 1e3
            log(f"  {kernel}: {k_ms:.3f} ms = {100 * k_ms / busy_ms:.1f}% of "
                f"the {phase}'s device time")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
                f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
                f"x{e.count:<5d} {e.key[:90]}")


def _rand(shape, gen, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _matmul_inputs(M, N, K, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return _rand((M, K), g, dtype), _rand((K, N), g, dtype)


def _scan_inputs(b, S, d, N, dtype, seed=0):
    """As tests/test_kernels.py makes them: dt = softplus(z), A = -exp(0.3 z),
    D = 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = _rand((b, S, d), g, dtype)
    dt = F.softplus(_rand((b, S, d), g)).to(dtype)
    B, C = _rand((b, S, N), g, dtype), _rand((b, S, N), g, dtype)
    A = -torch.exp(0.3 * _rand((d, N), g))
    return x, dt, B, C, A, torch.ones(d, device="cuda")


def check_new_kernels():
    """The matmul and scan kernels against their plain versions on the card,
    the matmul in each variant of ``_variants``.  Returns each kernel's
    largest float32 error over the model grid."""
    model = {"matmul": calibrate.MODEL_GRIDS["matmul"],
             "mamba_scan": calibrate.MODEL_GRIDS["mamba"]}
    worst = {"matmul": 0.0, "mamba_scan": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        tol = MM_TOL[dtype]
        for M, N, K in MM_CASES:
            a, b = _matmul_inputs(M, N, K, dtype)
            expect = ref.matmul_ref(a, b)
            for name in _variants(mm, dtype, M, N, K):
                out = _ran(mm.matmul, name,
                           lambda: mm.matmul(a, b, kernel=name))
                if out.dtype != dtype or out.shape != (M, N):
                    raise AssertionError(f"matmul gave {out.dtype} "
                                         f"{out.shape}")
                err = _check(f"matmul kernel {name} vs plain {(M, N, K)} "
                             f"{dtype}", out, expect, tol, tol * K ** 0.5)
                if dtype == torch.float32 and (M, N, K) in model["matmul"]:
                    worst["matmul"] = max(worst["matmul"], err)
        tol = SCAN_TOL[dtype]
        for shape in SCAN_CASES:
            args = _scan_inputs(*shape, dtype)
            out = ms.mamba_scan(*args)
            torch.cuda.synchronize()
            if out.dtype != dtype or out.shape != args[0].shape:
                raise AssertionError(f"scan gave {out.dtype} {out.shape}")
            err = _check(f"mamba_scan kernel vs plain {shape} {dtype}", out,
                         ref.mamba_scan_ref(*args), tol, 4 * tol)
            if dtype == torch.float32 and shape in model["mamba_scan"]:
                worst["mamba_scan"] = max(worst["mamba_scan"], err)
    return worst


def check_calibration_shapes():
    """All three kernels against their plain versions on the card at every
    shape of the ``"model"`` and ``"full"`` grids, on the calibration's own
    float32 inputs (``calibrate._inputs``), at the float32 tolerances above.
    Returns each kernel's largest error."""
    plain = {"matmul": ref.matmul_ref, "attention": ref.flash_attention_ref,
             "mamba": ref.mamba_scan_ref}
    worst = dict.fromkeys(plain, 0.0)
    for grid in ("model", "full"):
        for kernel in calibrate.KERNELS:
            for shape in calibrate.GRIDS[grid][kernel]:
                args, _, _ = calibrate._inputs(kernel, shape,
                                               torch.device("cuda"))
                out = calibrate._CALLS[kernel](*args)
                torch.cuda.synchronize()
                tol = CAL_TOL[kernel]
                atol = {"matmul": tol * shape[2] ** 0.5, "attention": tol,
                        "mamba": 4 * tol}[kernel]
                worst[kernel] = max(worst[kernel], _check(
                    f"calibration {grid} {kernel} {tuple(shape)} kernel vs "
                    "plain", out, plain[kernel](*args), tol, atol))
    return worst


def matmul_bound(M, N, K, dtype, variant):
    """Least time (ms) of a variant: its operations at their peak (bf16 on
    the tensor cores; float32 ``tf32x3`` as 3 x 2 M N K TF32 operations on
    the tensor cores; float32 ``stream`` and ``fma`` as 2 M N K on the CUDA
    cores) against a and b read once and c written once at the HBM rate."""
    itemsize = torch.finfo(dtype).bits // 8
    if variant == "tf32x3":
        ops = 3 * 2 * M * N * K / hw.PEAK_FLOPS_TF32
    else:
        ops = 2 * M * N * K / (hw.PEAK_FLOPS if dtype == torch.float32
                               else hw.PEAK_FLOPS_BF16)
    terms = {"operations": ops,
             "bytes": itemsize * (M * K + K * N + M * N) / hw.HBM_BW}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by, terms


def scan_bound(b, S, d, N, dtype, states=0):
    """Least time (ms), the largest of three terms: the float32 operations
    (the calibration's accounting, 10 b S d N) at the float32 peak; the
    b S d N exponentials at the special-function units' rate; x, dt, B, C,
    A, D read once, y written once and ``states`` float32 (b, d, N) states
    moved once (1: h_S written; 2: h0 read too) at the HBM rate."""
    itemsize = torch.finfo(dtype).bits // 8
    terms = {"operations": calibrate.mamba_cost(b, S, d, N)[0] / hw.PEAK_FLOPS,
             "exp": b * S * d * N / hw.EXP_RATE,
             "bytes": (itemsize * (3 * b * S * d + 2 * b * S * N)
                       + 4 * (d * N + d) + 4 * states * b * d * N)
             / hw.HBM_BW}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by, terms


def profile_tf32x3(call, shape, smi, calls=10):
    """A ``tf32x3`` call's device time by kernel (the split pass and the
    product) over ``calls`` calls, with ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    ms = {e.key: e.self_device_time_total / 1e3 / calls
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    if not ms:
        log(f"matmul tf32x3 {shape} profile: no device time in the trace "
            "(not measured)")
        return
    split = sum(t for k, t in ms.items() if "tf32_split" in k)
    total = sum(ms.values())
    log(f"matmul tf32x3 {shape} profile: split pass {split:.4f} ms, product "
        f"{total - split:.4f} ms a call ({100 * split / total:.1f}% split); "
        f"card {smi}")


def time_new_kernels(smi):
    """Kernel (each variant of ``_variants``), plain and library times (CUDA
    events) and the wrappers' host time a call at the model grid's shapes,
    in float32 and bf16.  Returns the float32 rows (the type the calibration
    loop runs; the matmul's in the variant its rule names) by kernel, and
    the float32 ms by variant and shape of the matmul."""
    rows = {"matmul": [], "mamba_scan": []}
    by_variant = {}
    for dtype in (torch.float32, torch.bfloat16):
        for M, N, K in calibrate.MODEL_GRIDS["matmul"]:
            a, b = _matmul_inputs(M, N, K, dtype, seed=2)
            plain = cuda_ms(lambda: ref.matmul_ref(a, b), 20, hold=False)
            lib = cuda_ms(lambda: torch.matmul(a, b), 20)
            for name in _variants(mm, dtype, M, N, K):
                def call():
                    return mm.matmul(a, b, kernel=name)
                kernel_ms, host = cuda_ms(call, 20), host_us(call)
                b_ms, by, terms = matmul_bound(M, N, K, dtype, name)
                tflops = 2 * M * N * K / kernel_ms / 1e9
                log(f"matmul {name} {(M, N, K)} {dtype}: kernel "
                    f"{kernel_ms:.4f} ms ({tflops:.2f} TFLOP/s; host "
                    f"{host:.1f} us a call), plain {plain:.4f} "
                    f"ms, torch.matmul {lib:.4f} ms, bound {b_ms:.4f} ms by "
                    f"{by} (ops {1e3 * terms['operations']:.4f}, bytes "
                    f"{1e3 * terms['bytes']:.4f} ms) = "
                    f"{100 * b_ms / kernel_ms:.2f}% of bound; card {smi}")
                if dtype != torch.float32:
                    continue
                by_variant.setdefault(name, {})[f"{M}x{N}x{K}"] = kernel_ms
                if name == mm.variant(M, N, K, dtype):
                    rows["matmul"].append(dict(
                        ms=kernel_ms, plain_ms=plain, library_ms=lib,
                        bound_ms=b_ms, bound_by=by, host_us=host))
                if name == "tf32x3":
                    profile_tf32x3(call, (M, N, K), smi)
        for shape in calibrate.MODEL_GRIDS["mamba"]:
            args = _scan_inputs(*shape, dtype, seed=2)
            plain = cuda_ms(lambda: ref.mamba_scan_ref(*args), 2, hold=False)
            b_ms, by, terms = scan_bound(*shape, dtype)

            def call():
                return ms.mamba_scan(*args)
            kernel_ms, host = cuda_ms(call, 20), host_us(call)
            log(f"mamba_scan L=4 {shape} {dtype}: kernel {kernel_ms:.4f} ms "
                f"(host {host:.1f} us a call), plain {plain:.4f} ms, library "
                f"none, bound {b_ms:.4f} ms by {by} (ops "
                f"{1e3 * terms['operations']:.4f}, exp "
                f"{1e3 * terms['exp']:.4f}, bytes "
                f"{1e3 * terms['bytes']:.4f} ms) = "
                f"{100 * b_ms / kernel_ms:.2f}% of bound; card {smi}")
            if dtype == torch.float32:
                rows["mamba_scan"].append(dict(
                    ms=kernel_ms, plain_ms=plain, library_ms=None,
                    bound_ms=b_ms, host_us=host,
                    bound_by="bytes" if by == "bytes" else "operations"))
    return rows, by_variant


def _loops(lines):
    """SASS lines of one function (``cuobjdump -sass``, branch targets as
    addresses) -> [(address, instruction)] and its loops, as the (first,
    last) addresses of each backward branch's range."""
    ins, loops = [], []
    for line in lines:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        ins.append((addr, m.group(2)))
        target = re.search(r"\bBRA\s+0x([0-9a-f]+)", m.group(2))
        if target and int(target.group(1), 16) <= addr:
            loops.append((int(target.group(1), 16), addr))
    return ins, loops


def scan_sass(lib, kernel):
    """SASS instructions per (thread, timestep) of the scan's loop over
    time, from ``cuobjdump -sass`` of the library ``lib``: in the function
    whose name holds ``kernel``, the innermost loop with the most
    exponentials (MUFU.EX2, which expf also ends in), its instructions over
    its timesteps (its exponentials over the N / 4 states a thread holds,
    N read from the name's template arguments).  Returns (instructions per
    step, instructions, timesteps)."""
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    funcs = out.split("Function : ")[1:]
    body = [f for f in funcs if kernel in f.splitlines()[0]]
    if len(body) != 1:
        raise AssertionError(f"{len(body)} SASS functions match {kernel}")
    states = int(re.search(r"Li(\d+)E", body[0].splitlines()[0])[1]) // 4
    ins, loops = _loops(body[0].splitlines())

    def ex2(lo, hi):
        return sum("MUFU.EX2" in t for a, t in ins if lo <= a <= hi)

    live = [(lo, hi) for lo, hi in loops if ex2(lo, hi)]
    inner = [(lo, hi) for lo, hi in live
             if not any((a, b) != (lo, hi) and lo <= a and b <= hi
                        for a, b in live)]
    lo, hi = max(inner, key=lambda r: ex2(*r))
    n = sum(lo <= a <= hi for a, _ in ins)
    steps = ex2(lo, hi) / states
    return n / steps, n, steps


def run_calibration():
    """The calibration loop on the card, the path that runs the matmul and
    scan kernels: every count is set to 0 just before it and read just
    after.  Returns the launches by kernel and by variant, and the records
    by grid (phase 22 prices the nets from the ``model`` grid's)."""
    wrappers = {"matmul": mm.matmul, "flash_attention": fa.flash_attention,
                "mamba_scan": ms.mamba_scan}
    mm.reset_counts()
    fa.reset_counts()
    ms.mamba_scan.launches = 0
    records_by_grid = {}
    for grid, repeat in CALIBRATION:
        t0 = time.perf_counter()
        records, meta = calibrate.measure(grid=grid, repeat=repeat)
        records_by_grid[grid] = records
        report = calibrate.build_report(records, meta)
        log(f"calibration grid {grid} repeat {repeat} on {meta['device']} "
            f"(backend {meta['backend']}, interpret {meta['interpret']}): "
            f"{len(records)} samples in {time.perf_counter() - t0:.1f} s")
        if meta["backend"] != "cuda" or meta["interpret"]:
            raise AssertionError(f"calibration ran no kernel: {meta}")
        for r in records:
            log(f"  {r['kernel']} {tuple(r['shape'])}: "
                f"{1e3 * r['measured_s']:.4f} ms, {r['flops'] / 1e9:.4f} "
                f"GFLOP, {r['bytes'] / 1e6:.4f} MB")
        for kernel, fit in report["kernels"].items():
            f = fit["fitted"]
            log(f"  fit {grid} {kernel}: roofline_mape "
                f"{fit['roofline_mape']:.4g}, fitted_mape "
                f"{fit['fitted_mape']:.4g}, peak_flops_eff "
                f"{f['peak_flops_eff']}, bw_eff {f['bw_eff']}, overhead_s "
                f"{f['overhead_s']}, table_max_rel_err "
                f"{fit['table_max_rel_err']}")
            if fit["table_max_rel_err"] != 0.0:
                raise AssertionError(f"{kernel} table does not reproduce "
                                     "its samples")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expect = {name: sum((1 + repeat) * len(calibrate.GRIDS[grid][kernel])
                        for grid, repeat in CALIBRATION)
              for name, kernel in (("matmul", "matmul"),
                                   ("flash_attention", "attention"),
                                   ("mamba_scan", "mamba"))}
    log(f"kernel launches in the calibration loop: {launches} (expected "
        f"{expect}: one warm-up and {CALIBRATION[0][1]} timed calls per "
        "shape)")
    if launches != expect:
        raise AssertionError(f"calibration launches {launches} != {expect}")
    by_variant = {
        "matmul": dict(mm.matmul.launches_by_variant),
        "flash_attention": dict(fa.flash_attention.launches_by_variant),
        "mamba_scan": {"cuda": launches["mamba_scan"]}}
    log(f"by variant: {by_variant}")
    # float32: each kernel in the variants its rule names (the matmul:
    # stream for M <= 16, tf32x3 above; flash: tf32x3 at head dims 64, 128
    # and 256, fma at the others)
    rules = {"matmul": ("matmul", lambda shape: mm.variant(
                 *shape, torch.float32)),
             "flash_attention": ("attention", lambda shape: fa.variant(
                 shape[-1], torch.float32))}
    for wrapper, (kernel, rule_of) in rules.items():
        rule = {}
        for grid, repeat in CALIBRATION:
            for shape in calibrate.GRIDS[grid][kernel]:
                name = rule_of(shape)
                rule[name] = rule.get(name, 0) + 1 + repeat
        ran = {k: n for k, n in by_variant[wrapper].items() if n}
        if ran != rule or sum(rule.values()) != launches[wrapper]:
            raise AssertionError(f"{wrapper} ran {ran} in float32, its rule "
                                 f"names {rule}")
    return launches, by_variant, records_by_grid


def _products(g):
    """The graph's convolution and matmul nodes: the products the matmul
    kernel runs."""
    return [g.nodes[k] for k in g.order
            if g.nodes[k].op in ("convolution", "matmul")]


def _path_launches(run):
    """``run()`` with the matmul's counts set to 0 just before it; returns
    its result and its launches by variant, read just after."""
    mm.reset_counts()
    out = run()
    torch.cuda.synchronize()
    return out, {k: n for k, n in mm.matmul.launches_by_variant.items() if n}


def check_graphs():
    """Each Table-III net at each batch of ``GRAPH_BATCHES`` on the card and
    on the CPU with the same params and input.  Returns the graphs by (net,
    batch), the matmul's launches by variant summed over the nets by batch,
    and the largest error of a conv or FC node."""
    graphs, by_batch, worst = {}, {}, 0.0
    for net in PAPER_NETS.values():
        for batch in GRAPH_BATCHES:
            g = graphs[net.name, batch] = build_paper_graph(net, batch)
            feeds = {"input": np.random.default_rng(batch).standard_normal(
                (batch, *net.input_shape)).astype(np.float32)}
            card, ran = _path_launches(lambda: g.values(feeds, device="cuda"))
            expect = GRAPH_LAUNCHES[net.name][batch]
            log(f"graph {net.name} batch {batch}: matmul launches {ran} "
                f"(rule: {expect})")
            if ran != expect:
                raise AssertionError(f"{net.name} batch {batch} ran {ran}, "
                                     f"the rule names {expect}")
            for k, n in ran.items():
                by_batch.setdefault(batch, {}).setdefault(k, 0)
                by_batch[batch][k] += n
            plan = g.fusion_plan()
            for n in _products(g):
                node = graph_ops.run_node(
                    g, n, {i: card[i].cpu() for i in n.inputs}, plan)
                w = card[n.inputs[1]]
                K, N = w.numel() // w.shape[-1], w.shape[-1]
                M = node.numel() // N
                worst = max(worst, _check(
                    f"graph {net.name} batch {batch} {n.name} {(M, N, K)} "
                    f"{mm.variant(M, N, K, torch.float32)} vs plain on the "
                    f"card's inputs", card[n.name].cpu(), node, MM_TOL[
                        torch.float32], MM_TOL[torch.float32] * K ** 0.5))
            cpu = g.values(feeds, device="cpu")
            for o in g.outputs:
                scale = cpu[o].abs().max().item()
                err = _check(f"graph {net.name} batch {batch} {o} card vs "
                             "CPU", card[o].cpu(), cpu[o], GRAPH_TOL,
                             GRAPH_TOL * scale)
                log(f"  {o}: max_abs_err / max|CPU| = {err / scale:.3e}")
    return graphs, by_batch, worst


def _is_matmul_kernel(key):
    """Whether a profiled kernel is one of ``csrc/nvdla_matmul.cu``'s."""
    return any(name in key for name in ("matmul_", "tf32_split_kernel",
                                        "splitk_sum_kernel"))


def profile_graph(forward, wall_ms, smi, runs=5):
    """Device time of a forward by kernel over ``runs`` forwards: the matmul
    kernels' share against the rest (im2col copies, pads, activations,
    pools, norms), and the device's busy share of the median wall time
    measured without the profiler (and of the profiled wall time, which
    the profiler's host cost lengthens)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            forward()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0) / runs
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    if not events:
        log("  profile: no device time in the trace (not measured)")
        return None
    total = sum(e.self_device_time_total for e in events) / 1e3 / runs
    mm_ms = sum(e.self_device_time_total for e in events
                if _is_matmul_kernel(e.key)) / 1e3 / runs
    log(f"  profile ({runs} forwards): device {total:.4f} ms a "
        f"forward = matmul kernels {mm_ms:.4f} ({100 * mm_ms / total:.1f}%) "
        f"+ other {total - mm_ms:.4f}; busy {100 * total / wall_ms:.1f}% of "
        f"the {wall_ms:.4f} ms wall ({100 * total / prof_ms:.1f}% of the "
        f"profiled {prof_ms:.4f} ms); card {smi}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3 / runs:9.4f} ms "
            f"x{e.count // runs:<4d} {e.key[:90]}")
    return {"device_ms": total, "matmul_ms": mm_ms}


def time_graphs(graphs, smi):
    """Per net and batch: the forward's median wall ms over ``GRAPH_RUNS``
    synchronized runs after 3 warm-ups, images/s, the matmul kernel's
    device ms summed over the forward's products (each timed alone on the
    forward's own operands) beside their summed bound and ``torch.matmul``
    on the same operands, and the profiled breakdown.  Returns, by (net,
    batch), the median wall ms and the profile's device and matmul ms a
    forward (None where the trace held no device time)."""
    measured = {}
    for (net, batch), g in graphs.items():
        gen = torch.Generator(device="cuda").manual_seed(batch)
        feeds = {"input": torch.randn(batch, *PAPER_NETS[net].input_shape,
                                      generator=gen, device="cuda")}

        def forward():
            return g.execute(feeds, device="cuda")
        for _ in range(3):
            forward()
        walls = []
        for _ in range(GRAPH_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        wall = statistics.median(walls)
        vals = g.values(feeds, device="cuda")
        kernel_ms = library_ms = bound_ms = 0.0
        for n in _products(g):
            a, b, _ = graph_ops.matmul_operands(n, vals)
            (M, K), N = a.shape, b.shape[1]
            name = mm.variant(M, N, K, torch.float32)
            k_ms = cuda_ms(lambda: mm.matmul(a, b), 20)
            l_ms = cuda_ms(lambda: torch.matmul(a, b), 20)
            b_ms = matmul_bound(M, N, K, torch.float32, name)[0]
            log(f"  {net} batch {batch} {n.name} {(M, N, K)} {name}: kernel "
                f"{k_ms:.4f} ms, torch.matmul {l_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({100 * b_ms / k_ms:.1f}%)")
            kernel_ms, library_ms, bound_ms = (kernel_ms + k_ms,
                                               library_ms + l_ms,
                                               bound_ms + b_ms)
        log(f"graph {net} batch {batch}: forward {wall:.4f} ms median of "
            f"{GRAPH_RUNS} (min {min(walls):.4f}, max {max(walls):.4f}), "
            f"{1e3 * batch / wall:.1f} images/s; its {len(_products(g))} "
            f"products: matmul kernel {kernel_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({100 * bound_ms / kernel_ms:.1f}%), "
            f"torch.matmul {library_ms:.4f} ms; card {smi}")
        prof = profile_graph(forward, wall, smi) or {}
        measured[net, batch] = {"wall_ms": wall,
                                "device_ms": prof.get("device_ms"),
                                "matmul_ms": prof.get("matmul_ms")}
    return measured


def check_camera(smi):
    """One 720x1280 frame (ISP, then CNN10 at batch 1) on the card against
    the CPU, with the matmul's launches counted; then the median of
    ``GRAPH_RUNS`` frames against the budget.  Returns the launches and the
    median ISP, CNN10 and frame ms."""
    g = build_paper_graph(PAPER_NETS["cnn10"], 1)
    raw = camera.raw_frame(0)
    camera.run_frame(raw, g, "cuda")        # warm-up
    out, ran = _path_launches(lambda: camera.run_frame(raw, g, "cuda"))
    log(f"camera frame {camera.FRAME_HW}: matmul launches {ran} (CNN10 at "
        f"batch 1: {GRAPH_LAUNCHES['cnn10'][1]})")
    if ran != GRAPH_LAUNCHES["cnn10"][1]:
        raise AssertionError(f"camera frame ran {ran}")
    cpu = camera.run_frame(raw, g, "cpu")
    for key in ("rgb", "dnn_in"):
        _check(f"camera {key} card vs CPU", out[key].cpu(), cpu[key], 0.0,
               ISP_TOL)
    _check("camera CNN10 logits card vs CPU", out["logits"].cpu(),
           cpu["logits"], GRAPH_TOL,
           GRAPH_TOL * cpu["logits"].abs().max().item())
    if out["cls"] != cpu["cls"]:
        raise AssertionError(f"class {out['cls']} on the card, {cpu['cls']} "
                             "on the CPU")
    frames = [camera.run_frame(raw, g, "cuda") for _ in range(GRAPH_RUNS)]
    med = {k: statistics.median(f[k] for f in frames)
           for k in ("isp_ms", "cnn_ms", "frame_ms")}
    log(f"camera frame on the card, median of {GRAPH_RUNS}: ISP "
        f"{med['isp_ms']:.4f} ms, CNN10 {med['cnn_ms']:.4f} ms, frame "
        f"{med['frame_ms']:.4f} ms against {camera.BUDGET_MS:g} ms: "
        f"{'MEETS' if med['frame_ms'] < camera.BUDGET_MS else 'MISSES'}; "
        f"class {out['cls']}; CPU frame {cpu['frame_ms']:.3f} ms; card {smi}")
    return ran, med


def _scan_serve_shape(cfg):
    """(b, S, d_inner, N) of one falcon_mamba_7b prefill batch in ``SERVE``."""
    return (SERVE["batch"], SERVE["prompt_len"],
            cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state)


def check_scan_state(serve_shape):
    """The scan with its state, float32, kernel against plain on the card:
    y and h_S from zeros and from a random h0 at every ``SCAN_CASES`` shape
    and at ``serve_shape``; then the prompt split in two at S / 2 + 3 (off
    the 32-step chunk), the kernel on the first part and on the rest from
    its h_S, against one call over the whole.  Returns the largest error."""
    tol, worst = SCAN_TOL[torch.float32], 0.0
    for shape in SCAN_CASES + [serve_shape]:
        b, S, d, N = shape
        args = _scan_inputs(*shape, torch.float32, seed=4)
        h0 = torch.randn(b, d, N, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(5))
        for start, h in (("zeros", None), ("h0", h0)):
            y, hT = ms.mamba_scan(*args, h0=h, return_state=True)
            ey, ehT = ref.mamba_scan_ref(*args, h0=h, return_state=True)
            for what, out, expect in (("y", y, ey), ("h_S", hT, ehT)):
                worst = max(worst, _check(
                    f"mamba_scan from {start} {shape} {what} kernel vs plain",
                    out, expect, tol, 4 * tol))
        x, dt, B, C, A, D = args
        cut = S // 2 + 3
        y1, h1 = ms.mamba_scan(x[:, :cut], dt[:, :cut], B[:, :cut],
                               C[:, :cut], A, D, h0=h0, return_state=True)
        y2, h2 = ms.mamba_scan(x[:, cut:], dt[:, cut:], B[:, cut:],
                               C[:, cut:], A, D, h0=h1, return_state=True)
        y12 = torch.cat([y1, y2], 1)
        for what, out, expect in (("y", y12, y), ("h_S", h2, hT)):
            _check(f"mamba_scan {shape} split at {cut} {what} vs one call "
                   f"(bit-equal: {torch.equal(out, expect)})", out, expect,
                   tol, 4 * tol)
    return worst


def check_falcon_against_cpu():
    """falcon_mamba_7b cut to ``FALCON_CUT`` layers at full width, params
    from a seed made on the card and copied to the CPU: prefill logits, the
    ``conv`` and ``ssm`` caches and 2 decode steps fed the CPU's greedy
    tokens, on the card (the scan kernel) against the CPU (plain path)."""
    cfg = dataclasses.replace(get_config("falcon_mamba_7b"),
                              n_layers=FALCON_CUT)
    gpu = T.init_params(cfg, seed=1, device="cuda")
    cpu = to_device(gpu, "cpu")
    B, S = FALCON_PROMPTS
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(1))
    log(f"falcon check: {cfg.name} cut to {cfg.n_layers} layers at d_model "
        f"{cfg.d_model}, tokens {tuple(tokens.shape)}, card vs CPU")
    before = ms.mamba_scan.launches
    out, toks = {}, []
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        logits, cache = T.prefill_forward(cfg, params,
                                          {"tokens": tokens.to(dev)},
                                          max_seq=S + 2)
        steps = [logits]
        for i in range(2):   # both sides take the CPU's greedy tokens
            if dev == "cpu":
                toks.append(torch.argmax(logits[:, -1], -1, keepdim=True))
            logits, cache = T.decode_forward(cfg, params, cache,
                                             toks[i].to(dev), S + i)
            steps.append(logits)
        out[dev] = steps + [cache]
    torch.cuda.synchronize()
    launches = ms.mamba_scan.launches - before
    log(f"  scan launches on the card: {launches} (expected {cfg.n_layers})")
    if launches != cfg.n_layers:
        raise AssertionError("falcon check did not go through the kernel "
                             f"once a layer: {launches}")
    for i in range(3):
        _bf16_close(f"logits step {i}", out["cuda"][i], out["cpu"][i])
    for key in ("conv", "ssm"):
        _bf16_close(f"cache {key}", out["cuda"][3][key], out["cpu"][3][key])


def _numel(tree):
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def serve_falcon():
    """falcon_mamba_7b at full width and depth through ``serve``; the scan's
    count is set to 0 just before and read just after.  Returns the config,
    the params and the scan's launches."""
    cfg = get_config("falcon_mamba_7b")
    params = T.init_params(cfg, seed=0, device="cuda")
    log(f"serve: {cfg.name} full width, {cfg.n_layers} Mamba1 layers, "
        f"d_model {cfg.d_model}, d_inner {cfg.ssm.expand * cfg.d_model}, N "
        f"{cfg.ssm.d_state}, vocab {cfg.vocab}, {_numel(params) / 1e9:.3f} B "
        f"params; {SERVE}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms.mamba_scan.launches = 0
    stats = serve(cfg, device="cuda", seed=0, params=params, log=log, **SERVE)
    launches = ms.mamba_scan.launches
    expect = cfg.n_layers * stats["batches"]
    log(f"mamba_scan launches in serving: {launches} (expected "
        f"{cfg.n_layers} layers x {stats['batches']} prefill batches = "
        f"{expect})")
    if launches != expect:
        raise AssertionError(f"{launches} scan launches, expected {expect}")
    _log_serving(stats)
    return cfg, params, launches


def time_scan_serving(shape, smi):
    """The scan at ``shape`` (float32) with no state, with h_S out (what
    prefill runs) and with h0 in and h_S out: {state: row} of kernel ms,
    host us a call, the plain version's ms (with both) and the bound."""
    args = _scan_inputs(*shape, torch.float32, seed=2)
    b, _, d, N = shape
    h0 = torch.randn(b, d, N, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(3))
    plain = cuda_ms(lambda: ref.mamba_scan_ref(*args, h0=h0,
                                               return_state=True),
                    2, hold=False)
    rows = {}
    for name, kw, states in (("none", {}, 0),
                             ("h_S", dict(return_state=True), 1),
                             ("h0+h_S", dict(h0=h0, return_state=True), 2)):
        def call():
            return ms.mamba_scan(*args, **kw)
        kernel_ms, host = cuda_ms(call, 20), host_us(call)
        b_ms, by, terms = scan_bound(*shape, torch.float32, states=states)
        log(f"mamba_scan serving shape {shape} state {name}: kernel "
            f"{kernel_ms:.4f} ms (host {host:.1f} us a call), plain "
            f"{plain:.4f} ms, library none, bound {b_ms:.4f} ms by {by} (ops "
            f"{1e3 * terms['operations']:.4f}, exp {1e3 * terms['exp']:.4f}, "
            f"bytes {1e3 * terms['bytes']:.4f} ms) = "
            f"{100 * b_ms / kernel_ms:.2f}% of bound; card {smi}")
        rows[name] = dict(ms=kernel_ms, plain_ms=plain, library_ms=None,
                          bound_ms=b_ms, host_us=host,
                          bound_by="bytes" if by == "bytes" else "operations")
    return rows


def copy_latency(smi, elems=16384):
    """Log the device ms of one small copy (``elems`` float32, the default
    tile of ``Graph.program``), back to back: the per-copy latency of the
    tiling target (``core/tiling.py::H100``)."""
    src = torch.randn(elems, device="cuda")
    dst = torch.empty_like(src)
    t = cuda_ms(lambda: dst.copy_(src), 200)
    log(f"one {4 * elems // 1024} KiB device copy, back to back: {t:.6f} ms "
        f"(tiling target's copy latency {1e3 * H100_TILING.copy_latency_s:g} "
        f"ms); card {smi}")


def _tile_counts(g, max_tile_elems):
    """Each compute node's tile count as ``choose_tiling`` chooses it at the
    H100's target, the node's tensor as ``from_graph`` views it."""
    counts = {}
    for name in g.order:
        n = g.nodes[name]
        if n.op in ("input", "weight"):
            continue
        shape4 = tuple(n.shape) if len(n.shape) == 4 else \
            (1, 1, 1, math.prod(n.shape))
        counts[name] = max(choose_tiling(
            TensorSpec(shape4, "NHWC", "float32"), max_tile_elems,
            reduce_dim="C" if n.op in ("convolution", "matmul") else None)
            .n_tiles, 1)
    return counts


def _price(program, config):
    """One engine run: the result and the engine's own CPU seconds."""
    t0 = time.thread_time()
    res = sim.run(program, config)
    return res, time.thread_time() - t0


def _price_configs(table, host_s):
    """The three backends of phases 22-23 on one H100 (one worker, the hbm
    interface, the H100's constants): the roofline, the measured table, and
    the table with the matmul wrapper's host time charged a dispatch."""
    return {"roofline": sim.EngineConfig(),
            "table": sim.EngineConfig(cost_backend=table),
            "table+host": sim.EngineConfig(cost_backend=table,
                                           host_dispatch_s=host_s)}


def _price_line(label, res, cpu_s, wall_ms, device_ms=None):
    """Log one price beside the card's wall ms and, where profiled, its
    device ms."""
    f = res.breakdown.fractions()
    mk = 1e3 * res.makespan
    if not (math.isfinite(mk) and mk > 0):
        raise AssertionError(f"{label}: makespan {mk} ms")
    by_device = f"{mk / device_ms:.4f}" if device_ms else "not measured"
    log(f"  {label}: priced {mk:.6f} ms (accelerator "
        f"{100 * f['accelerator']:.1f}%, transfer {100 * f['transfer']:.1f}%"
        f", host {100 * f['host']:.1f}%), {len(res.program.ops)} ops, engine "
        f"{cpu_s:.3f} s CPU; price / wall {mk / wall_ms:.4f}, price / "
        f"device {by_device}")


def check_table(table, records):
    """The table still returns each of its samples' seconds exactly."""
    for r in records:
        got = table.op_time(sim.CostedOp("sample", flops=r["flops"],
                                         op_kind=r["kind"]))
        if got != r["measured_s"]:
            raise AssertionError(f"table gives {got} s for {r['kind']} "
                                 f"{r['shape']}, measured {r['measured_s']}")


def price_nets(table, host_s, measured, smi):
    """Phase 22: each Table-III net at each batch, not cut, lowered by
    ``Graph.program`` at the default 16,384-element tiles and at one tile a
    node, priced on one H100 under the roofline, the measured ``table`` and
    the table with ``host_s`` a dispatch, beside the card's median wall ms
    and profiled device and matmul ms (phase 11)."""
    kinds = sorted({kind for kind, _, _ in table.samples})
    log(f"price: table of {len(table.samples)} samples ({kinds}); host "
        f"dispatch {1e6 * host_s:.1f} us (the matmul wrapper's host time a "
        f"call, phase 8); card {smi}")
    for net in PAPER_NETS.values():
        for batch in GRAPH_BATCHES:
            g = build_paper_graph(net, batch)
            card = measured[net.name, batch]
            dev, mmk = card["device_ms"], card["matmul_ms"]
            log(f"price {net.name} batch {batch}: card wall "
                f"{card['wall_ms']:.4f} ms, device "
                + (f"{dev:.4f} ms, matmul {mmk:.4f} ms ({100 * mmk / dev:.1f}"
                   f"% of device, {100 * mmk / card['wall_ms']:.1f}% of wall)"
                   if dev else "not measured"))
            one = max(math.prod(n.shape) for n in g.nodes.values()
                      if n.op not in ("input", "weight"))
            for tiling, elems in (("16384", 16384), ("node", one)):
                prog = g.program(batch, max_tile_elems=elems)
                counts = _tile_counts(g, elems)
                if len(prog.ops) != sum(counts.values()):
                    raise AssertionError(f"{net.name} {len(prog.ops)} ops, "
                                         f"tilings {sum(counts.values())}")
                if tiling == "node" and set(counts.values()) != {1}:
                    raise AssertionError(f"{net.name} tiles at {elems}")
                for name, cfg in _price_configs(table, host_s).items():
                    res, cpu_s = _price(prog, cfg)
                    _price_line(f"{net.name} b{batch} tiles {tiling} "
                                f"{name}", res, cpu_s, card["wall_ms"], dev)


def price_frame(table, host_s, frame_ms, smi):
    """Phase 23: the camera frame (the ISP's stages at 720x1280, then CNN10
    at batch 1) priced as in phase 22 beside phase 12's ms, and once on the
    camera SoC (ISP on the frontend CPU, CNN10 on 4 H100-rate
    accelerators)."""
    cnn10 = build_paper_graph(PAPER_NETS["cnn10"], 1).program(1)
    isp = camera_program(camera.FRAME_HW, camera.DNN_HW,
                         device_class="accel")
    frame = isp.then(cnn10, name="frame")
    log(f"price camera frame {camera.FRAME_HW}: card ISP "
        f"{frame_ms['isp_ms']:.4f} ms, CNN10 {frame_ms['cnn_ms']:.4f} ms, "
        f"frame {frame_ms['frame_ms']:.4f} ms; card {smi}")
    for name, cfg in _price_configs(table, host_s).items():
        for part, prog, key in (("ISP", isp, "isp_ms"),
                                ("CNN10", cnn10, "cnn_ms"),
                                ("frame", frame, "frame_ms")):
            res, cpu_s = _price(prog, cfg)
            _price_line(f"{part} {name}", res, cpu_s, frame_ms[key])
    soc = camera_soc()
    res, cpu_s = _price(camera_program(camera.FRAME_HW, camera.DNN_HW)
                        .then(cnn10, name="frame"),
                        sim.EngineConfig(topology=soc))
    _price_line(f"frame on {soc.name} ({soc.describe()}) roofline", res,
                cpu_s, frame_ms["frame_ms"])
    log(f"  per device: {res.per_device}")
    if not {"cpu0", "acc0"} <= set(res.per_device):
        raise AssertionError(f"frame on the SoC ran on {set(res.per_device)}")


def _counts():
    """Every kernel wrapper's launch count."""
    return (mm.matmul.launches, dict(mm.matmul.launches_by_variant),
            fa.flash_attention.launches,
            dict(fa.flash_attention.launches_by_variant),
            ms.mamba_scan.launches)


def _mean_row(rows):
    """One launch of the model grid: the mean of each time over its shapes;
    bound_by is that of the shape with the largest bound."""
    out = {key: (None if rows[0][key] is None
                 else sum(r[key] for r in rows) / len(rows))
           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "host_us")}
    out["bound_by"] = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
    return out


def _head_dim_rows(small):
    """``time_flash_small``'s rows for the JSON line: by type and shape,
    each variant's ms beside the plain version's, SDPA's and the bound (with
    the term that sets it)."""
    out = {}
    for (shape, dtype), rows in small.items():
        first = next(iter(rows.values()))
        out[f"{str(dtype)[6:]} {'x'.join(map(str, shape))}"] = {
            "ms_by_variant": {name: r["ms"] for name, r in rows.items()},
            **{k: first[k] for k in ("plain_ms", "library_ms", "bound_ms",
                                     "bound_term")}}
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 plain versions need TF32 off")
    name, smi = identify()
    build_kernels()
    # the scan's loop over time, float32, N = 16
    per_step, n, steps = scan_sass(_build.library_path("mamba_scan"),
                                   "mamba_scan_kernelIfLi16EE")
    log(f"mamba_scan L=4 SASS: {per_step:.2f} instructions per (thread, "
        f"timestep) ({n} in a loop of {steps:g} steps)")
    max_err, f32_err = check_kernel()
    check_model_against_cpu()
    cfg, params, launches, by_variant = serve_full()
    rows = time_kernel(cfg, smi)
    profile_serving(cfg, params, smi)
    del params
    torch.cuda.empty_cache()
    new_err = check_new_kernels()
    cal_err = check_calibration_shapes()
    new_rows, mm_by_variant = time_new_kernels(smi)
    log(f"matmul float32 ms by variant and shape: {mm_by_variant}")
    f32_rows = time_flash_f32(smi)
    f32_flash = {name: _mean_row(r) for name, r in f32_rows.items()}
    shapes = ["x".join(map(str, shape))
              for shape in calibrate.MODEL_GRIDS["attention"]]
    for var, r in f32_flash.items():
        log(f"flash_attention {var} float32, mean over the model grid (what "
            f"the calibration runs): {r}; ms by shape "
            f"{dict(zip(shapes, (x['ms'] for x in f32_rows[var])))}")
    cal_launches, cal_by_variant, cal_records = run_calibration()
    graphs, graph_by_batch, graph_err = check_graphs()
    graph_ms = time_graphs(graphs, smi)
    del graphs
    camera_launches, frame_ms = check_camera(smi)
    serve_shape = _scan_serve_shape(get_config("falcon_mamba_7b"))
    state_err = check_scan_state(serve_shape)
    check_falcon_against_cpu()
    torch.cuda.empty_cache()
    fcfg, fparams, scan_serve_launches = serve_falcon()
    profile_serving(fcfg, fparams, smi, kernel="mamba_scan_kernel")
    del fparams
    torch.cuda.empty_cache()
    scan_rows = time_scan_serving(serve_shape, smi)
    scan_by_path = {"calibration": cal_launches["mamba_scan"],
                    "falcon_mamba_7b serving": scan_serve_launches}
    log(f"mamba_scan launches by path: {scan_by_path}")
    check_model_against_cpu("phi3_mini_3_8b", PHI3_CUT, PHI3_PROMPTS)
    torch.cuda.empty_cache()
    pcfg, pparams, _, phi3_by_variant = serve_full("phi3_mini_3_8b")
    profile_serving(pcfg, pparams, smi, kernel="flash_fwd_")
    del pparams
    torch.cuda.empty_cache()
    small = time_flash_small(smi)
    # phases 22-23: the simulator's price of each net and the frame, from
    # the model grid's table, beside the card's times; they launch nothing
    counts = _counts()
    copy_latency(smi)
    host_s = 1e-6 * _mean_row(new_rows["matmul"])["host_us"]
    table = calibrate.table_backend(cal_records["model"])
    check_table(table, cal_records["model"])
    price_nets(table, host_s, graph_ms, smi)
    price_frame(table, host_s, frame_ms, smi)
    if _counts() != counts:
        raise AssertionError(f"pricing changed the launch counts: {counts} "
                             f"-> {_counts()}")
    flash_by_path = {"gemma3_1b serving": by_variant,
                     "phi3_mini_3_8b serving": phi3_by_variant,
                     "calibration": cal_by_variant["flash_attention"]}
    log(f"flash_attention launches by path: {flash_by_path}")
    mm_by_path = {"calibration": cal_by_variant["matmul"],
                  **{f"graph batch {b}": n for b, n in graph_by_batch.items()},
                  "camera frame": camera_launches}
    log(f"matmul launches by path: {mm_by_path}")
    # one launch of the main path, averaged over its 26-layer local/global
    # mix, in each bf16 variant; the JSON line gives the one serving runs
    sched = T._window_schedule(cfg)
    mix = {w: sched.count(w) / len(sched) for w in rows}
    served = fa.variant(cfg.resolved_head_dim, torch.bfloat16)
    avg = {name: {key: sum(mix[w] * rows[w][name][key] for w in rows)
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "host_us")}
           for name in rows[0]}
    log(f"flash_attention serving mix by variant: {avg}")
    by = max(rows.values(),
             key=lambda r: r[served]["bound_ms"])[served]["bound_by"]
    log(smi)   # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:99",
        "launches": launches, "launches_by_variant": by_variant,
        "launches_by_path": flash_by_path,
        "max_abs_err": max_err, **avg[served], "bound_by": by,
        "ms_by_variant": {name: row["ms"] for name, row in avg.items()},
        "head_dims": _head_dim_rows(small)}, {
        "name": "flash_attention_fp32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:99",
        "launches": cal_launches["flash_attention"],
        "launches_by_variant": cal_by_variant["flash_attention"],
        "max_abs_err": max(f32_err, cal_err["attention"]),
        **f32_flash[fa.variant(256, torch.float32)],
        "ms_by_variant": {name: r["ms"] for name, r in f32_flash.items()}}, {
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/nvdla_matmul.cu",
        "replaces": "src/repro/kernels/nvdla_matmul.py:60",
        "launches": cal_launches["matmul"],
        "launches_by_variant": cal_by_variant["matmul"],
        "max_abs_err": max(new_err["matmul"], cal_err["matmul"], graph_err),
        **_mean_row(new_rows["matmul"]), "ms_by_variant": mm_by_variant,
        "launches_by_path": mm_by_path}, {
        # the serving path's shape, with h_S out as prefill runs it
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:59",
        "launches": scan_serve_launches, "launches_by_path": scan_by_path,
        "max_abs_err": max(new_err["mamba_scan"], cal_err["mamba"],
                           state_err),
        **scan_rows["h_S"], "shape": list(serve_shape),
        "ms_by_state": {name: r["ms"] for name, r in scan_rows.items()},
        "model_grid": _mean_row(new_rows["mamba_scan"])}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
