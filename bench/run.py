"""The benchmark of ``repro_torch`` on NVIDIA H100 cards.

  python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It runs one cell of ``BENCHMARK.json`` on
this machine's card: the program's serving steps over the cell's traffic,
with weights and prompts made from ``--seed``; set-up (imports, the
kernels' build or load, the weights, a warm-up of the cell's shapes), then
a window of ``--seconds``; then the check of what the window served
against the plain reference.  With ``--trace 0`` the result holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiler trace of part of the window.  The last line of standard
output is the result, one JSON object; the numbers compared, each beside
its limit, close standard error.

It fails, printing no result, where there is no card or fewer than the
cell asks for, where the program cannot be imported, and where ``jax``
or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()   # set-up counts from here: the process's start

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")


def environment():
    """Every cache the program or its libraries write goes inside the
    checkout, at fixed paths: the program builds its kernels into
    ``build/kernels`` there itself."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))


def banned_modules():
    """Top-level names of loaded modules that are JAX's or its package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED))


class NoCard(RuntimeError):
    pass


def require_cards(n: int):
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: the benchmark "
                     "measures the card and has no CPU fallback")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell asks for {n} cards; "
                     f"{torch.cuda.device_count()} present")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0, steps=None) -> dict:
    """Runs the cell on ``device`` and returns its result.  ``steps``
    stands in for the program's serving steps (``yardstick.program.Steps``
    by default)."""
    import torch
    from yardstick import check, loop, program, weights
    from yardstick.trace import (NoTrace, Tracer, breakdown, busy_seconds,
                                 window_seconds)
    marks = [("imports", time.perf_counter())]
    device = torch.device(device)
    cuda = device.type == "cuda"
    spec, traffic = cell.config, cell.traffic

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    torch.zeros(1, device=device)
    sync()
    marks.append(("device", time.perf_counter()))
    steps = steps or program.Steps(spec)
    marks.append(("program", time.perf_counter()))
    params = weights.make(spec, seed, device)
    sync()
    marks.append(("weights", time.perf_counter()))
    tracer = Tracer(traffic["trace"]) if trace else NoTrace()
    if trace:
        tracer.warm(lambda: torch.ones(8, device=device).add_(1).sum().item())
        marks.append(("profiler", time.perf_counter()))
    loop.warm(steps, params, spec, traffic, device, log=log)
    sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    parts = ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b)
                      in zip([("", t0)] + marks, marks))
    log(f"{cell.name}: set-up {setup_s:.3f} s ({parts}); window {seconds} s")

    window = loop.serve(steps, params, spec, traffic, seed, seconds, device,
                        tracer)
    sync()
    peak = window.peak
    reduced = tracer.finish()
    record = {"spec": spec, "traffic": traffic,
              "units": loop.units_as_dicts(window),
              "window": {"begin": window.begin, "end": window.end},
              "trace": reduced}
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = setup_s if m["name"] == "setup_s" \
            else cell.readers[m["name"]](record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda
           else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": window.requests,
              "failed": window.failed, "metrics": metrics, "device": dev}
    if trace:
        if reduced is None:
            raise RuntimeError("the window closed before the traced units "
                               "had run: no trace to read")
        dev["busy_s"] = busy_seconds(reduced)
        dev["window_s"] = window_seconds(reduced)
        result["breakdown"] = breakdown(reduced)
    log(f"{cell.name}: window {window.end - window.begin:.3f} s, "
        f"{len(window.units)} units, {window.requests} requests; "
        f"checking {sum(len(k.slots) for k in window.kept)} of them; "
        f"peak {peak} B, less the check's kept copies (at most "
        f"{window.kept_bytes} B)")

    kept = window.kept
    del window, record, reduced
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.program_numbers(spec, params, kept)
    log(f"{cell.name}: check {time.perf_counter() - t_check:.3f} s")
    result["correct"], result["checked"] = check.verdict(numbers,
                                                         cell.limits)
    return result


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    from yardstick import cell as cells
    cell = cells.find(args.workload)
    try:
        require_cards(cell.chips)
    except NoCard as e:
        log(f"no result: {e}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda")
    found = banned_modules()
    if found:
        log(f"no result: modules of JAX or of its package were loaded: "
            f"{', '.join(found)}")
        return 3
    for name, c in result["checked"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
