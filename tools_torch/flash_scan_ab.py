"""Times the flash attention and scan kernels of two checkouts on one card.

  python3 tools_torch/flash_scan_ab.py --a OLD_CHECKOUT --b NEW_CHECKOUT \\
      [--rounds 1] [--out FILE]

Each checkout's kernels run in a process of its own whose ``repro_torch`` is
that checkout's ``src/`` (so each is built from its own ``csrc/`` into its
own ``build/kernels/``), in the order a, b, b, a, ``--rounds`` times, so that
a drift of the card's clocks falls on both alike.  Every call takes the
kernel's default tile, as every model path does: flash attention in bf16
(``wgmma``) at the served prefill shapes of each head dim and in float32
(``tf32x3``) at two of them, and the scan at the calibration's ``model``
grid and the serving shape (float32 and bf16).  Each process first checks
every output against the plain version (``ref``) on the card, then
records the kernel's ms a call (CUDA events around back-to-back calls
queued behind a device-side sleep, as ``matmul_ab.py`` times them).

Prints one line a case (each checkout's median ms and every run's) and the
card's name and power limit; ``--out`` also writes every run's rows as
JSON.  Needs one CUDA card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

from matmul_ab import cuda_ms

# (B, H, Hkv, S, D, window): the served prefill shapes (phi3 at D 16, 32
# and 96, tinyllama_1_1b's training shape at D 64, zamba2, internvl2,
# deepseek, gemma3_1b's global and local layers), causal
FLASH_BF16 = [(4, 32, 32, 1024, 16, 0), (4, 32, 32, 1024, 32, 0),
              (4, 32, 4, 4096, 64, 0), (4, 32, 32, 1024, 80, 0),
              (4, 32, 32, 1024, 96, 0), (4, 48, 8, 1280, 128, 0),
              (4, 16, 16, 1024, 192, 0), (4, 4, 1, 1024, 256, 0),
              (4, 4, 1, 1024, 256, 512)]
FLASH_F32 = [(4, 32, 32, 1024, 96, 0), (4, 4, 1, 1024, 256, 0)]
# (b, S, d, N): the calibration's model grid, then the serving shape
SCAN = [(1, 512, 8192, 16), (1, 1024, 8192, 16), (1, 2048, 8192, 16),
        (4, 2048, 8192, 16), (4, 1024, 8192, 16)]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}        # tests/test_kernels.py
SCAN_TOL = {"float32": 2e-4, "bfloat16": 8e-2}


def _close(out, expect, tol, atol, label):
    err = (out.float() - expect.float()).abs().max().item()
    ok = bool(((out.float() - expect.float()).abs()
               <= atol + tol * expect.float().abs()).all())
    if not ok:
        raise AssertionError(f"{label}: max_abs_err {err}")
    return err


def worker():
    """One checkout's rows, as JSON on the last line of stdout."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for dtype, shapes in ((torch.bfloat16, FLASH_BF16),
                          (torch.float32, FLASH_F32)):
        for B, H, Hkv, S, D, window in shapes:
            q, k, v = (torch.randn(s, generator=g, device="cuda").to(dtype)
                       for s in ((B, H, S, D), (B, Hkv, S, D),
                                 (B, Hkv, S, D)))
            label = f"flash {str(dtype)[6:]} {(B, H, Hkv, S, D)} w{window}"

            def call():
                return ops.flash_attention(q, k, v, window=window)
            tol = TOL[str(dtype)[6:]]
            err = _close(call(), ref.flash_attention_ref(q, k, v,
                                                         window=window),
                         tol, tol, label)
            rows.append(dict(case=label, max_abs_err=err,
                             ms=cuda_ms(torch, call)))
    for b, S, d, N in SCAN:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(b, S, d, generator=g, device="cuda")
            dt = F.softplus(torch.randn(b, S, d, generator=g, device="cuda"))
            Bm, C = (torch.randn(b, S, N, generator=g, device="cuda")
                     for _ in range(2))
            A = -torch.exp(0.3 * torch.randn(d, N, generator=g,
                                             device="cuda"))
            args = (x.to(dtype), dt.to(dtype), Bm.to(dtype), C.to(dtype), A,
                    torch.ones(d, device="cuda"))
            label = f"scan {str(dtype)[6:]} {(b, S, d, N)}"

            def call():
                return ops.mamba_scan(*args)
            tol = SCAN_TOL[str(dtype)[6:]]
            err = _close(call(), ref.mamba_scan_ref(*args), tol, 4 * tol,
                         label)
            rows.append(dict(case=label, max_abs_err=err,
                             ms=cuda_ms(torch, call)))
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

    def med(which, i):
        return statistics.median(r[i]["ms"] for r in runs[which])
    for i, row in enumerate(runs["b"][0]):
        print(f"{row['case']}: a {med('a', i):.5f} ms "
              f"{[round(r[i]['ms'], 5) for r in runs['a']]}; b "
              f"{med('b', i):.5f} ms {[round(r[i]['ms'], 5) for r in runs['b']]}"
              f"; b/a {med('b', i) / med('a', i):.4f}")
    print(f"card {smi}")
    if args.out:
        Path(args.out).write_text(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
