"""Readings for the limits of ``limits/<workload>.json``, on the card, in
one process: for each seed, weights and traffic from the seed, a short
window at the cell's own load (the benchmark's loop and steps), and the
check's numbers of the program's kept outputs; for the first
``--control-seeds`` seeds, the same numbers of the control, the reference
in float8 in the program's place (``yardstick.check.control_numbers``).

  python bench/tools/calibrate.py --workload phi3-prefill --seconds 10 \\
      --seeds 12 --control-seeds 3 --first-seed 4000000001

One JSON line a seed on standard output: {"seed", "program": {...},
"control": {...} or null, "kept", "window_s"}.  The lower reading of a
number is the largest of the program's over the seeds, the upper the
smallest of the control's (``PERF.md`` gives both beside each limit).
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_000_000_001)
    args = ap.parse_args(argv)
    run.environment()
    import torch
    from yardstick import cell as cells
    from yardstick import check, loop, program, weights
    cell = cells.find(args.workload)
    run.require_cards(cell.chips)
    spec, traffic = cell.config, cell.traffic
    steps = program.Steps(spec)
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        params = weights.make(spec, seed, "cuda")
        if i == 0:
            loop.warm(steps, params, spec, traffic, "cuda")
        w = loop.serve(steps, params, spec, traffic, seed, args.seconds,
                       "cuda")
        kept = w.kept
        span = w.end - w.begin
        del w
        torch.cuda.empty_cache()
        t = time.perf_counter()
        layers = []
        prog = check.program_numbers(spec, params, kept, layers)
        t_prog = time.perf_counter() - t
        ctrl = None
        if i < args.control_seeds:
            ctrl = check.control_numbers(spec, params, kept)
        line = {"workload": args.workload, "seed": seed, "program": prog,
                "control": ctrl,
                "kept": sum(len(k.slots) for k in kept),
                "prompts": [k.prompt_len for k in kept],
                "window_s": span, "check_s": t_prog,
                "cache_by_layer": [max(r[i] for r in layers)
                                   for i in range(len(layers[0]))],
                "control_s": time.perf_counter() - t - t_prog}
        print(json.dumps(line), flush=True)
        del params, kept
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
