"""Measured-vs-modeled calibration against the port's CUDA kernels.

The counterpart of ``repro/kernels/calibrate.py``: time the port's kernels
(``nvdla_matmul``, ``flash_attention``, ``mamba_scan``) over a shape grid,
best of ``repeat``, then fit per-kernel cost parameters
``t ~= flops/peak + bytes/bw + overhead`` by least squares
(:func:`repro_torch.sim.backends.fit_linear_cost`) and build a measured
:class:`repro_torch.sim.backends.TableBackend`.  The grids, the (flops,
bytes) accounting, the fit and the report are the reference's; the roofline
defaults are the H100's (``repro_torch.sim.hw``).

On the card (the default) each sample is the best of ``repeat`` CUDA-event
timings of one call after one warm-up call, and the kernels run; the events
time the card alone, not the wrapper's host work (:func:`_best_of`).  With
``device="cpu"`` the plain PyTorch versions run, timed by ``perf_counter``:
those samples say nothing about the card (``meta["interpret"]`` is True).

The reference's grids were sized for Pallas interpret mode on a CPU; on the
card they take microseconds, so a fit over them measures launch overhead.
The ``"model"`` grid adds shapes at the full widths of gemma3_1b (matmul,
attention) and falcon_mamba_7b (scan).

  python -m repro_torch.kernels.calibrate --grid model --out cal.json
  python -m repro_torch.kernels.calibrate --grid quick --device cpu
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import zlib
from time import perf_counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.sim import backends as sim_backends
from repro_torch.sim import hw

BYTES = 4  # kernels are measured in fp32

# Shape grids.  Each kernel's shapes carry pairwise-distinct flop counts
# on purpose: the measured TableBackend keys its exact round-trip on
# (kind, flops), so two shapes with equal flops but different runtimes
# would make "reproduce your own samples" unsatisfiable.
# (M, N, K) matmul grid
MATMUL_GRID: Tuple[Tuple[int, int, int], ...] = (
    (128, 128, 128), (256, 128, 128), (256, 256, 128),
    (256, 256, 256), (512, 256, 256), (512, 512, 256))
# (B, H, Hkv, S, D) attention grid (GQA rows keep KV at Hkv heads)
ATTENTION_GRID: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 2, 2, 128, 32), (2, 2, 2, 128, 32), (1, 4, 2, 128, 64),
    (1, 2, 1, 256, 64), (2, 4, 2, 256, 32))
# (b, S, d, N) selective-scan grid
MAMBA_GRID: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 32, 16, 8), (1, 64, 32, 8), (2, 64, 32, 16), (1, 128, 64, 16))

QUICK_GRIDS = {"matmul": MATMUL_GRID[:2], "attention": ATTENTION_GRID[:2],
               "mamba": MAMBA_GRID[:2]}
FULL_GRIDS = {"matmul": MATMUL_GRID, "attention": ATTENTION_GRID,
              "mamba": MAMBA_GRID}
# Full widths of the repo's configs.  matmul: gemma3_1b's projections
# (d_model 1152, d_ff 6912, vocab 262,144) at prefill (4 requests x 1024
# tokens = 4096 rows) and decode (4 rows); the last streams a 1.2 GB float32
# weight and is the bandwidth-bound sample.  attention: gemma3_1b's MQA heads
# (4 on 1, head dim 256).  mamba: falcon_mamba_7b's mixer (d_inner 2 x 4096,
# d_state 16).
MODEL_GRIDS = {
    "matmul": ((4096, 1024, 1152), (4096, 6912, 1152), (1024, 6912, 1152),
               (4, 1152, 6912), (4, 262144, 1152)),
    "attention": ((1, 4, 1, 1024, 256), (4, 4, 1, 1024, 256),
                  (2, 4, 1, 2048, 256), (1, 4, 1, 4096, 256)),
    "mamba": ((1, 512, 8192, 16), (1, 1024, 8192, 16), (1, 2048, 8192, 16),
              (4, 2048, 8192, 16)),
}
GRIDS = {"quick": QUICK_GRIDS, "full": FULL_GRIDS, "model": MODEL_GRIDS}
KERNELS = tuple(FULL_GRIDS)


# ---------------------------------------------------------------------------
# analytic accounting: nominal (flops, bytes) per kernel invocation.
# Attention bytes charge KV at its native Hkv heads — the kernel indexes
# KV by group instead of materializing the broadcast, so measured and
# modeled traffic compare like with like.


def matmul_cost(M: int, N: int, K: int) -> Tuple[float, float]:
    return 2.0 * M * N * K, float(BYTES * (M * K + K * N + M * N))


def attention_cost(B: int, H: int, Hkv: int, S: int, D: int,
                   causal: bool = True) -> Tuple[float, float]:
    flops = 4.0 * B * H * S * S * D * (0.5 if causal else 1.0)
    bytes_ = BYTES * (2.0 * B * H * S * D + 2.0 * B * Hkv * S * D)
    return flops, bytes_


def mamba_cost(b: int, S: int, d: int, N: int) -> Tuple[float, float]:
    flops = 10.0 * b * S * d * N
    bytes_ = BYTES * (3.0 * b * S * d + 2.0 * b * S * N + d * N + d)
    return flops, bytes_


# ---------------------------------------------------------------------------
# measurement


# Device cycles of the wait queued ahead of each timed call on the card:
# about 5 ms at the H100's 1.98 GHz boost clock, some 100 times a wrapper's
# host work.
HOLD_CYCLES = 10_000_000


def _best_of(fn, repeat: int, device: torch.device) -> float:
    """Seconds of the fastest of ``repeat`` calls, after one warm-up call.

    On the card the start event is queued behind a device-side wait
    (``torch.cuda._sleep``) that outlasts the wrapper's host work (argument
    checks, allocation, the ctypes call), so a sample is the kernel's time
    on the card and not the host's.  A sample whose host work outlasted the
    wait is dropped and taken again with a wait twice as long."""
    fn()
    best, taken, hold = math.inf, 0, HOLD_CYCLES
    while taken < max(repeat, 1):
        if device.type == "cuda":
            held, start, end = (torch.cuda.Event(enable_timing=True)
                                for _ in range(3))
            t0 = perf_counter()
            held.record()
            torch.cuda._sleep(hold)
            start.record()
            fn()
            end.record()
            host = perf_counter() - t0
            end.synchronize()
            if host >= held.elapsed_time(start) / 1e3:
                hold *= 2
                if hold > 64 * HOLD_CYCLES:
                    raise RuntimeError("host work outlasts the device wait")
                continue
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = perf_counter()
            fn()
            seconds = perf_counter() - t0
        best, taken = min(best, seconds), taken + 1
    return best


def _inputs(kernel: str, shape: Sequence[int],
            device: torch.device) -> Tuple[Tuple, float, float]:
    """The kernel's float32 inputs from a generator seeded by the kernel's
    name and shape (stable across processes), and its (flops, bytes).

    The scan takes dt = softplus(z) and A = -exp(0.3 z), as a model feeds
    it (and as ``tests/test_kernels.py`` does): with the reference's
    dt = z and A = -|z| the state grows without bound over thousands of
    steps."""
    rng = np.random.default_rng(
        zlib.crc32(repr((kernel, tuple(shape))).encode()))

    def rand(*s):
        return torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) \
            .to(device)

    if kernel == "matmul":
        M, N, K = shape
        return (rand(M, K), rand(K, N)), *matmul_cost(M, N, K)
    if kernel == "attention":
        B, H, Hkv, S, D = shape
        return (rand(B, H, S, D), rand(B, Hkv, S, D), rand(B, Hkv, S, D)), \
            *attention_cost(B, H, Hkv, S, D)
    if kernel == "mamba":
        b, S, d, N = shape
        x, dt = rand(b, S, d), torch.nn.functional.softplus(rand(b, S, d))
        Bm, C = rand(b, S, N), rand(b, S, N)
        A, D = -torch.exp(0.3 * rand(d, N)), rand(d)
        return (x, dt, Bm, C, A, D), *mamba_cost(b, S, d, N)
    raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")


_CALLS = {"matmul": ops.matmul, "attention": ops.flash_attention,
          "mamba": ops.mamba_scan}
# the tiles a grid's samples pass, as the reference's do: attention at bq =
# bk = 64 on the reference's grids; the model grid takes the defaults
GRID_TILES = {"quick": {"attention": {"bq": 64, "bk": 64}},
              "full": {"attention": {"bq": 64, "bk": 64}}}


def _measure_kernel(kernel: str, shape: Sequence[int], repeat: int,
                    device: torch.device, **kw) -> Dict:
    args, flops, bytes_ = _inputs(kernel, shape, device)
    call = _CALLS[kernel]
    seconds = _best_of(lambda: call(*args, **kw), repeat, device)
    return {"kernel": kernel, "kind": kernel, "shape": list(shape),
            "flops": flops, "bytes": bytes_, "measured_s": seconds}


def measure(grid: str = "full", repeat: int = 3,
            kernels: Sequence[str] = KERNELS,
            device="cuda") -> Tuple[List[Dict], Dict]:
    """Time the kernels over the named shape grid (``quick``, ``full`` or
    ``model``) on ``device``.

    Returns ``(records, meta)``: per-shape records with the analytic
    (flops, bytes) accounting and best-of-``repeat`` seconds, plus meta
    naming the backend (``cuda`` or ``cpu``), whether the kernels ran
    (``interpret`` is False only then) and the device's name.  Raises when
    ``device`` is ``cuda`` and there is no card."""
    if grid not in GRIDS:
        raise ValueError(f"unknown grid {grid!r}; one of {sorted(GRIDS)}")
    for kernel in kernels:
        if kernel not in KERNELS:
            raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")
    device = resolve_device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"measure runs on cuda or cpu, not {device}")
    tiles = GRID_TILES.get(grid, {})
    records = [_measure_kernel(kernel, shape, repeat, device,
                               **tiles.get(kernel, {}))
               for kernel in kernels for shape in GRIDS[grid][kernel]]
    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    return records, {"backend": device.type, "interpret": not on_card,
                     "grid": grid, "repeat": repeat, "device": name}


# ---------------------------------------------------------------------------
# fitting + error reporting


def roofline_pred(records: Sequence[Dict],
                  peak_flops: float = hw.PEAK_FLOPS,
                  hbm_bw: float = hw.HBM_BW) -> np.ndarray:
    """The uncalibrated roofline prediction at the card's data-sheet
    constants: ``flops/peak + bytes/bw`` per record."""
    f = np.array([r["flops"] for r in records])
    b = np.array([r["bytes"] for r in records])
    return f / peak_flops + b / hbm_bw


def calibrate(records: Sequence[Dict]) -> Dict[str, Dict]:
    """Per-kernel least-squares fit + error summary.

    For each kernel: the fitted effective (peak, bandwidth, overhead)
    from :func:`repro_torch.sim.backends.fit_linear_cost`, the fitted MAPE,
    the uncalibrated-roofline MAPE, and the measured-table round-trip
    error (0 by construction — asserted, not assumed)."""
    out: Dict[str, Dict] = {}
    for kernel in {r["kernel"] for r in records}:
        rs = [r for r in records if r["kernel"] == kernel]
        meas = np.array([r["measured_s"] for r in rs])
        fit = sim_backends.fit_linear_cost(
            [r["flops"] for r in rs], [r["bytes"] for r in rs], meas)
        roof = roofline_pred(rs)
        table = sim_backends.table_from_samples(rs)
        t_err = max(abs(table._lookup(r["kind"], r["flops"])
                        - r["measured_s"]) / r["measured_s"] for r in rs)
        # a dropped term fits as an infinite rate — JSON-encode it as
        # null rather than the non-standard Infinity literal
        fin = lambda v: float(v) if math.isfinite(v) else None  # noqa: E731
        out[kernel] = {
            "n_samples": len(rs),
            "roofline_mape": sim_backends.mape(roof, meas),
            "fitted_mape": fit["mape"],
            "fitted": {"peak_flops_eff": fin(fit["peak_flops_eff"]),
                       "bw_eff": fin(fit["bw_eff"]),
                       "overhead_s": fin(fit["overhead_s"])},
            "table_max_rel_err": t_err,
        }
    return out


def table_backend(records: Sequence[Dict]) -> "sim_backends.TableBackend":
    """A measured-sample :class:`TableBackend` over every record."""
    return sim_backends.table_from_samples(records)


def build_report(records: Sequence[Dict], meta: Dict,
                 fits: Optional[Dict[str, Dict]] = None) -> Dict:
    """The calibration report: the reference's ``BENCH_calibration.json``
    payload (sans recorded/budget)."""
    fits = calibrate(records) if fits is None else fits
    improved = sorted(k for k, f in fits.items()
                      if f["fitted_mape"] < f["roofline_mape"])
    return {
        "backend": meta["backend"], "interpret": meta["interpret"],
        "grid": meta["grid"], "repeat": meta["repeat"],
        "samples": list(records),
        "kernels": {k: fits[k] for k in sorted(fits)},
        "improved": improved,
        "n_improved": len(improved),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", choices=tuple(GRIDS), default="full")
    ap.add_argument("--repeat", type=int, default=3,
                    help="best-of-k repeats per shape (default 3)")
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS),
                    choices=list(KERNELS),
                    help="subset of kernels to measure")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="write the report JSON here instead of stdout")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    records, meta = measure(grid=args.grid, repeat=args.repeat,
                            kernels=args.kernels, device=args.device)
    report = dict(build_report(records, meta), device=meta["device"])
    text = json.dumps(report, indent=2, default=float) + "\n"
    if args.out:
        args.out.write_text(text)
        print(f"wrote {args.out}")
    else:
        sys.stdout.write(text)
    for name in sorted(report["kernels"]):
        f = report["kernels"][name]
        print(f"{name}: roofline_mape={f['roofline_mape']:.3g} -> "
              f"fitted_mape={f['fitted_mape']:.3g}", file=sys.stderr)


if __name__ == "__main__":
    main()
