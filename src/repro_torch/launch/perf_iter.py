"""Hillclimb step: trace one cell with a PerfFlags combo on the fake
16 x 16 mesh (``launch.dryrun``), analyze rank 0's step
(``core.hlo.analyze_step``), price it with ``core.simulator.roofline`` on
one H100 at its dense bf16 peak, and append the roofline terms to
experiments/perf_iters_torch.json.

  PYTHONPATH=src python -m repro_torch.launch.perf_iter --arch gemma3_1b \\
      --shape train_4k --perf attn_remat_chunk,windowed_attention

Nothing is allocated and no real process group starts.  The price is a
price, not a measurement.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.core.config import SHAPE_BY_NAME


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--perf", default="")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default="experiments/perf_iters_torch.json")
    args = ap.parse_args(argv)

    from repro_torch.core.simulator import roofline
    from repro_torch.launch import dryrun

    cfg = get_config(args.arch)
    shape = SHAPE_BY_NAME[args.shape]
    world, make_mesh = dryrun.MESHES["pod16x16"]
    t0 = time.time()
    with dryrun.fake_world(world):
        hlo, _ = dryrun.lower_cell(cfg, shape, make_mesh(), perf=args.perf,
                                   n_microbatches=args.microbatches)
    rl = roofline(hlo, cfg, shape, world)
    mem = hlo["memory"]
    rec = {"arch": args.arch, "shape": args.shape, "perf": args.perf,
           "microbatches": args.microbatches,
           "wall_s": round(time.time() - t0, 1),
           "temp_bytes": mem["temp_bytes"],
           "hlo": {k: hlo[k] for k in ("flops", "dot_flops", "bytes",
                                       "collective_bytes", "wire_bytes")},
           "collectives": hlo["collectives"],
           "roofline": rl.to_dict()}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    data = json.loads(out.read_text()) if out.exists() else {}
    key = f"{args.arch}|{args.shape}|{args.perf}|mb{args.microbatches}"
    data[key] = rec
    out.write_text(json.dumps(data, indent=1))
    r = rl.to_dict()
    print(f"{key}\n  compute={r['compute_s']:.3f}s memory={r['memory_s']:.3f}s "
          f"collective={r['collective_s']:.3f}s bound={r['bound']} "
          f"useful={r['useful_ratio']*100:.0f}% "
          f"rl_frac={r['roofline_fraction']*100:.2f}% "
          f"temp={mem['temp_bytes']/1e9:.1f}GB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
