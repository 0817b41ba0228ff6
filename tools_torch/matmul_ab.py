"""Times the NVDLA matmul kernel of two checkouts of the port on one card.

  python3 tools_torch/matmul_ab.py --a OLD_CHECKOUT --b NEW_CHECKOUT \\
      [--rounds 1] [--out FILE]

Each checkout's kernel runs in a process of its own whose ``repro_torch`` is
that checkout's ``src/`` (so each is built from its own ``csrc/`` into its
own ``build/kernels/``), in the order a, b, b, a, ``--rounds`` times, so that
a drift of the card's clocks falls on both alike.  At the calibration's
``model`` grid (``kernels/calibrate.py::MODEL_GRIDS``), the quickstart's two
convs and the graph path's (64, 128, 6272), in float32, each process records
by shape: the kernel's ms at its checkout's default tile and the wrapper's
host us a call (the chooser included where it has one); where its ``matmul``
takes blocks, also the ms at the tile the kernel fixed by itself before
(tf32x3 128 rows by 112 or 128 columns, never split: ``previous_tile``;
the stream kernel's tile and split rule are unchanged), so
the kernel's code is compared apart from the tile.  Every output is held
against ``torch.matmul`` in float64 first.  Kernel times are CUDA events
around back-to-back calls queued behind a device-side sleep, as
``chip_smoke.py``'s ``cuda_ms``.

Prints one line a shape (each checkout's times, the medians over its runs)
and the card's name and power limit; ``--out`` also writes every run's rows
as JSON.  Needs one CUDA card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

QUICKSTART_CONVS = [(1024, 64, 72), (1024, 8, 576)]
GRAPH_WORST = [(64, 128, 6272)]
ITERS = 20


def cuda_ms(torch, fn, iters=ITERS):
    """ms a call: CUDA events around ``iters`` calls queued behind a
    device-side sleep that outlasts their enqueue (doubled until it does),
    after 3 warm-ups."""
    for _ in range(3):
        fn()
    cycles = 2_000_000
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        if cycles > 1 << 34:
            raise RuntimeError("the calls' enqueue outlasted the sleep")
        cycles *= 2


def host_us(torch, fn, calls=100):
    """Host us a call over ``calls`` enqueues, the card left to run."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def previous_tile(M, N):
    """The tf32x3 tile the kernel fixed by itself before its tiles became
    launch parameters: 128 rows by 112 or 128 columns, whichever takes the
    fewer rounds of tiles over 132 SMs times its width (ties 128)."""
    tiles_m = -(-M // 128)

    def cost(bn):
        return -(-(-(-N // bn) * tiles_m) // 132) * bn
    return 128, 112 if cost(112) < cost(128) else 128, 32


def worker():
    """One checkout's rows, as JSON on the last line of stdout."""
    import inspect

    import torch
    from repro_torch.kernels import calibrate
    from repro_torch.kernels import nvdla_matmul as mm

    blocks = "bm" in inspect.signature(mm.matmul).parameters
    shapes = (list(calibrate.MODEL_GRIDS["matmul"]) + QUICKSTART_CONVS
              + GRAPH_WORST)
    rows = []
    for M, N, K in shapes:
        g = torch.Generator(device="cuda").manual_seed(4)
        a = torch.randn(M, K, generator=g, device="cuda")
        b = torch.randn(K, N, generator=g, device="cuda")
        expect = (a.double() @ b.double()).float()
        out = mm.matmul(a, b)
        err = (out - expect).abs().max().item()
        limit = 2e-4 * expect.abs().max().item() + 1e-4
        if not err <= limit:
            raise AssertionError(f"{(M, N, K)}: max_abs_err {err} > {limit}")
        row = dict(shape=[M, N, K], max_abs_err=err,
                   ms=cuda_ms(torch, lambda: mm.matmul(a, b)),
                   host_us=host_us(torch, lambda: mm.matmul(a, b)))
        if blocks:
            t = mm.tiling_of(M, N, K, torch.float32)
            row.update(tile=[t.bm, t.bn, t.bk], stages=t.stages,
                       splits=t.splits)
            if t.variant == "tf32x3":
                bm, bn, bk = previous_tile(M, N)
                row["previous_ms"] = cuda_ms(torch, lambda: mm.matmul(
                    a, b, bm=bm, bn=bn, bk=bk, splits=1))
            else:   # the stream kernel's one tile, its split rule kept
                bm, bn, bk = t.bm, t.bn, t.bk
                row["previous_ms"] = row["ms"]
            row["previous_tile"] = [bm, bn, bk]
        rows.append(row)
    print(json.dumps(rows))


def run_tree(tree):
    env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve() / "src"))
    proc = subprocess.run([sys.executable, __file__, "--worker"], env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"worker in {tree} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--a", help="the checkout timed first and last")
    p.add_argument("--b", help="the checkout timed in the middle")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--out")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        return worker()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    runs = {"a": [], "b": []}
    for _ in range(args.rounds):
        for which in ("a", "b", "b", "a"):
            runs[which].append(run_tree(getattr(args, which)))

    def med(which, i, key):
        return statistics.median(r[i][key] for r in runs[which])
    for i, row in enumerate(runs["b"][0]):
        line = (f"{tuple(row['shape'])}: a {med('a', i, 'ms'):.5f} ms "
                f"{[round(r[i]['ms'], 5) for r in runs['a']]}, host "
                f"{med('a', i, 'host_us'):.1f} us; b {med('b', i, 'ms'):.5f} "
                f"ms {[round(r[i]['ms'], 5) for r in runs['b']]}, host "
                f"{med('b', i, 'host_us'):.1f} us")
        if "previous_ms" in row:
            line += (f" at tile {tuple(row['tile'])} x{row['stages']} splits "
                     f"{row['splits']}; b at {tuple(row['previous_tile'])} "
                     f"{med('b', i, 'previous_ms'):.5f} ms")
        line += f"; b/a {med('b', i, 'ms') / med('a', i, 'ms'):.4f}"
        print(line)
    n_model = len(runs["b"][0]) - len(QUICKSTART_CONVS) - len(GRAPH_WORST)
    sums = {f"{w} {key}": sum(med(w, i, key) for i in range(n_model))
            for w, key in (("a", "ms"), ("b", "ms"), ("b", "previous_ms"))
            if key in runs[w][0][0]}
    print(f"model grid ({n_model} shapes), summed medians: " + ", ".join(
        f"{k} {v:.5f} ms" for k, v in sums.items()))
    print(f"card {smi}")
    if args.out:
        Path(args.out).write_text(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
