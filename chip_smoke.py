"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. identify the card (torch and nvidia-smi: name and power limit);
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels``;
3. hold each kernel against its plain PyTorch version on the card, at the
   ``tests/test_kernels.py`` shapes and at the serving shapes, with a ragged
   length; then a 6-layer cut of gemma3_1b at full width served on the card
   against the same params on the CPU (plain path) on one small input;
4. serve gemma3_1b at full width (26 layers, random params from a seed):
   8 requests, batch 4, prompt 1024, 32 new tokens, through
   ``repro_torch.launch.serve.serve``, counting the kernel's launches;
5. time the kernel at the serving shapes against its plain version and, as a
   yardstick only, ``F.scaled_dot_product_attention``, beside its bound;
6. profile one prefill batch and 8 decode steps with ``torch.profiler``:
   device time by kernel and the device's busy share of the wall time.

The line before the last is a JSON ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import to_device  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.step import (greedy, make_decode_step,  # noqa: E402
                                    make_prefill_step)

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
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
]
SERVE = dict(requests=8, batch=4, prompt_len=1024, max_new=32)


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
        if log_path.exists():   # ptxas report of a fresh build
            for line in log_path.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")


def check_kernel():
    """Every case in fp32 and bf16, kernel vs plain version on the card.
    Returns the largest error at the serving shapes in bf16."""
    worst = 0.0
    for case in KERNEL_CASES:
        B, H, Hkv, S, D, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = rand_qkv(B, H, Hkv, S, D, dtype)
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            expect = ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window)
            diff = (out.float() - expect.float()).abs()
            err = diff.max().item()
            tol = TOL[dtype]
            ok = bool((diff <= tol + tol * expect.float().abs()).all())
            log(f"kernel vs plain {case} {dtype}: max_abs_err {err:.3e} "
                f"(tol {tol}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"flash_attention mismatch at {case} "
                                     f"{dtype}: {err}")
            if D == 256 and dtype == torch.bfloat16:
                worst = max(worst, err)
    return worst


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


def check_model_against_cpu():
    """Six layers of gemma3_1b at full width (5 local, 1 global), prompt 600
    (> window 512): prefill logits and cache plus 2 teacher-forced decode
    steps on the card (through the kernel) against the CPU (plain path)."""
    cfg = dataclasses.replace(get_config("gemma3_1b"), n_layers=6)
    cpu = T.init_params(cfg, seed=1, device="cpu")
    gpu = to_device(cpu, "cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 600),
                           generator=torch.Generator().manual_seed(1))
    log(f"model check: {cfg.name} cut to {cfg.n_layers} layers, tokens "
        f"{tuple(tokens.shape)}, card vs CPU")
    before = fa.flash_attention.launches
    out, toks = {}, []
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        logits, cache = T.prefill_forward(cfg, params,
                                          {"tokens": tokens.to(dev)},
                                          max_seq=602)
        steps = [logits]
        for i in range(2):   # both sides take the CPU's greedy tokens
            if dev == "cpu":
                toks.append(torch.argmax(logits[:, -1], -1, keepdim=True))
            logits, cache = T.decode_forward(cfg, params, cache,
                                             toks[i].to(dev), 600 + i)
            steps.append(logits)
        out[dev] = steps + [cache]
    if fa.flash_attention.launches - before != cfg.n_layers:
        raise AssertionError("model check did not go through the kernel")
    for i in range(3):
        _bf16_close(f"logits step {i}", out["cuda"][i], out["cpu"][i])
    for key in ("k", "v"):
        _bf16_close(f"cache {key}", out["cuda"][3][key], out["cpu"][3][key])


def serve_full():
    cfg = get_config("gemma3_1b")
    log(f"serve: {cfg.name} full width, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.param_count() / 1e9:.3f} B "
        f"params; {SERVE}")
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    stats = serve(cfg, device="cuda", seed=0, params=params, log=log, **SERVE)
    launches = fa.flash_attention.launches
    expect = cfg.n_layers * stats["batches"]
    log(f"flash_attention launches in serving: {launches} (expected "
        f"{cfg.n_layers} layers x {stats['batches']} prefill batches = "
        f"{expect})")
    if launches != expect:
        raise AssertionError(f"{launches} flash launches, expected {expect}")
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
    return cfg, params, launches


def cuda_ms(fn, iters):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(B, H, Hkv, S, D, window, itemsize):
    """Least time (ms) for the work these inputs need: live (q, k) pairs
    times 4 D operations at the bf16 tensor-core peak, against q, k, v read
    once and o written once at the HBM rate."""
    live = sum(min(i + 1, window) if window else i + 1 for i in range(S))
    flops = 4 * D * B * H * live
    nbytes = (2 * B * H * S * D + 2 * B * Hkv * S * D) * itemsize
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def time_kernel(cfg, smi):
    B, H, Hkv, S, D = SERVE["batch"], cfg.n_heads, cfg.n_kv_heads, \
        SERVE["prompt_len"], cfg.resolved_head_dim
    rows = {}
    for window in (cfg.window, 0):
        q, k, v = rand_qkv(B, H, Hkv, S, D, torch.bfloat16, seed=2)
        pos = torch.arange(S, device="cuda")
        mask = pos[:, None] >= pos[None, :]
        if window:
            mask &= (pos[:, None] - pos[None, :]) < window
        lib = (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)) if not window else \
            (lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True))
        lib_err = (lib().float() - ref.flash_attention_ref(
            q, k, v, window=window).float()).abs().max().item()
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, window=window), 50)
        plain = cuda_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                        window=window), 20)
        lib_ms = cuda_ms(lib, 50)
        b_ms, b_by, flops, nbytes = bound(B, H, Hkv, S, D, window, 2)
        rows[window] = dict(ms=ms, plain_ms=plain, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by)
        log(f"flash_attention B={B} H={H} Hkv={Hkv} S={S} D={D} bf16 "
            f"window={window}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"SDPA {lib_ms:.4f} ms (max_abs_err vs plain {lib_err:.2e}), "
            f"bound {b_ms:.4f} ms by {b_by} ({flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.3f} MB), kernel {flops / ms / 1e9:.2f} TFLOP/s "
            f"= {100 * b_ms / ms:.2f}% of bound; card {smi}")
    return rows


def profile_serving(cfg, params, smi):
    """Device time by kernel over one prefill batch and over 8 decode steps,
    and the device's busy share: summed kernel time over the wall time of
    the profiled region (the profiler's own host cost lengthens the wall
    time, so the share is a lower bound)."""
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
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms "
                f"{100 * e.self_device_time_total / 1e3 / busy_ms:5.1f}% "
                f"x{e.count:<5d} {e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    name, smi = identify()
    build_kernels()
    max_err = check_kernel()
    check_model_against_cpu()
    cfg, params, launches = serve_full()
    rows = time_kernel(cfg, smi)
    profile_serving(cfg, params, smi)
    # one launch of the main path, averaged over its 26-layer local/global mix
    sched = T._window_schedule(cfg)
    mix = {w: sched.count(w) / len(sched) for w in rows}
    avg = {key: sum(mix[w] * rows[w][key] for w in rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by = max(rows.values(), key=lambda r: r["bound_ms"])["bound_by"]
    log(smi)   # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:99",
        "launches": launches, "max_abs_err": max_err,
        **avg, "bound_by": by}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
