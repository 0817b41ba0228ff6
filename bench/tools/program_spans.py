"""Readings of the program's own spans (``repro_torch.core.spans``) in one
traced window of a cell, on the card, in one process: set-up and the
window as ``run.py --trace 1`` runs them, then the trace's reduction with
the program's spans beside it (``yardstick.program_trace``), and no check.

  python bench/tools/program_spans.py --workload phi3-decode \\
      --seed 4000000001 --seconds 40 --out chiprun_out/spans.json

One JSON object on standard output (and in ``--out``): the card; the
share of kernels paired with their host op; the cell's per-layer metrics
read from this trace; the readings of the program's spans (``READINGS``);
the device time launched under each span and its largest device
operations; the blocking runtime calls inside each span; the runtime
calls by name; ``breakdown`` with ``idle_gaps_program`` beside
``idle_gaps``; the host clock of the traced and untraced units of the
traced kind.
"""
import argparse
import collections
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import run  # noqa: E402
from layer_metrics import _spans  # noqa: E402

GLUE = ("repro_torch.norm", "repro_torch.rope", "repro_torch.ssm.coeffs",
        "repro_torch.ssm.gate")
READINGS = {
    "attn_pct.decode": lambda r: _spans.launched_pct(
        r, "decode", ("repro_torch.attn.decode",)),
    "glue_pct.prefill": lambda r: _spans.launched_pct(r, "prefill", GLUE),
    "blocking_calls_per_step.decode": lambda r: _spans.blocking_per_unit(
        r, "decode", "repro_torch.serve.decode"),
}


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _runtime_calls(events):
    """{name: count} of the CUDA runtime and driver calls in ``events``."""
    from torch.autograd import DeviceType
    from yardstick.program_trace import RUNTIME_CALL
    return dict(collections.Counter(
        e.name() for e in events if e.device_type() == DeviceType.CPU
        and RUNTIME_CALL.match(e.name())).most_common(25))


def read(cell, seed, seconds, device):
    """The readings of one traced window of ``cell`` on ``device``."""
    import torch
    from yardstick import loop, program, program_trace, weights
    from yardstick.trace import (Tracer, breakdown, busy_seconds,
                                 window_seconds)
    spec, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
    steps = program.Steps(spec)
    params = weights.make(spec, seed, device)
    tracer = Tracer(traffic["trace"])
    tracer.warm(lambda: torch.ones(8, device=device).add_(1).sum().item())
    loop.warm(steps, params, spec, traffic, device)
    sync()
    window = loop.serve(steps, params, spec, traffic, seed, seconds, device,
                        tracer)
    sync()
    reduced = tracer.finish()
    if reduced is None:
        raise RuntimeError("the window closed before the traced units had "
                           "run: no trace to read")
    trace = {**reduced, **program_trace.reduce(tracer.events, reduced)}
    units = loop.units_as_dicts(window)
    record = {"spec": spec, "traffic": traffic, "units": units,
              "window": {"begin": window.begin, "end": window.end},
              "trace": trace}
    by_span = collections.Counter()
    ops = collections.defaultdict(collections.Counter)
    for (op, a, b), n in zip(trace["device"], trace["launch"]):
        by_span[n or "none"] += b - a
        ops[n or "none"][op[:90]] += b - a
    counts = collections.Counter(n for n, _, _ in trace["program_spans"])
    holders = program_trace.innermost(
        trace["program_spans"], [t for _, t, _ in trace["blocking"]])
    blocking = collections.Counter(
        f"{n} in {s or 'none'}" for (n, _, _), s in zip(trace["blocking"],
                                                        holders))
    kind = next(u["kind"] for u in units if u["traced"])
    step_ms = {}
    for traced in (True, False):
        ms = [1e3 * (u["end"] - u["call"]) for u in units
              if u["kind"] == kind and u["traced"] == traced]
        step_ms["traced" if traced else "untraced"] = {
            "n": len(ms), "mean": statistics.fmean(ms) if ms else None,
            "median": statistics.median(ms) if ms else None}
    busy = busy_seconds(trace)
    return {
        "workload": cell.name, "seed": seed,
        "device": torch.cuda.get_device_name(device) if cuda else device,
        "card": _card() if cuda else None,
        "paired": trace["paired"], "paired_by_op": trace["paired_by_op"],
        "kernels": len(trace["kernels"]),
        "per_layer": {m["name"]: cell.readers[m["name"]](record)
                      for m in cell.per_layer},
        "readings": {name: fn(record) for name, fn in READINGS.items()},
        "busy_s": busy, "window_s": window_seconds(trace),
        "launched_s": {n: t for n, t in by_span.most_common()},
        "launched_pct": {n: 100.0 * t / busy
                         for n, t in by_span.most_common()},
        "launched_ops_s": {n: c.most_common(6) for n, c in ops.items()},
        "spans": dict(counts),
        "blocking": dict(blocking),
        "runtime_calls": _runtime_calls(tracer.events),
        "breakdown": {**breakdown(trace),
                      "idle_gaps_program":
                          program_trace.idle_gaps_program(trace)},
        "step_ms": {"kind": kind, **step_ms},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.environment()
    from yardstick import cell as cells
    cell = cells.find(args.workload)
    run.require_cards(cell.chips)
    out = json.dumps(read(cell, args.seed, args.seconds, "cuda"))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(out + "\n")
    print(out, flush=True)


if __name__ == "__main__":
    main()
