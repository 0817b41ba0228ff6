"""The plain references against the program at small sizes on the CPU,
and the chunked float64 scan against the recurrence step by step."""
import ast
from pathlib import Path

import pytest
import torch

from reference import ssm as ref_ssm
from yardstick import check, program, weights

REFERENCE = Path(__file__).resolve().parents[1] / "reference"


def _std_err(prog, ref):
    return float(((prog.float() - ref).abs().amax(-1)
                  / ref.std(-1)).max())


@pytest.mark.parametrize("workload", ["phi3-prefill", "falcon-prefill"])
def test_reference_agrees_with_program(cell_of, workload):
    c = cell_of(workload)
    spec, limit = c.config, {k: v["limit"] for k, v in c.limits.items()
                             if k in check.NUMBERS}
    V = spec["model"]["vocab"]
    params = weights.make(spec, 11, "cpu")
    steps = program.Steps(spec)
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, V, (2, 40), generator=gen)
    logits, cache = steps.prefill(params, tokens, 44)
    tok = steps.greedy(logits)
    outs, step_logits = [tok], [logits]
    for i in range(3):
        tok, cache, lg = steps.decode(params, cache, tok, 40 + i)
        outs.append(tok)
        step_logits.append(lg)
    served = torch.cat(outs, 1)
    mod = check.family(spec)
    for b in range(2):
        seq = torch.cat([tokens[b], served[b, :-1]])
        errs = []

        def hook(li, state):
            for key, r in state.items():
                p = cache[key][li, b]
                if key in ("k", "v"):
                    p = p[:, :r.shape[1]]
                errs.append(float((p.float() - r).norm() / r.norm()))
        ref = mod.forward(spec, params, seq, torch.arange(39, 43), "fp32",
                          hook)
        prog = torch.stack([lg[b, -1] for lg in step_logits])
        # bf16 against float32, held to the cell's limits
        assert _std_err(prog, ref) < limit["logits"]
        assert max(errs) < limit["cache"]
        assert check._gap(ref, served[b]) < limit["gap"]


def _scan_steps(x, dt, Bm, Cm, A):
    h = torch.zeros(A.shape, dtype=torch.float64)
    ys = []
    for t in range(x.shape[0]):
        h = torch.exp(dt[t, :, None] * A) * h \
            + (dt[t] * x[t])[:, None] * Bm[t][None]
        ys.append(h @ Cm[t])
    return torch.stack(ys), h


@pytest.mark.parametrize("dt_scale", [0.05, 30.0])
def test_chunked_scan_is_the_recurrence(dt_scale):
    gen = torch.Generator().manual_seed(2)
    S, d, N = 150, 6, 4
    x, Bm, Cm = (torch.randn(S, k, generator=gen, dtype=torch.float64)
                 for k in (d, N, N))
    dt = torch.rand(S, d, generator=gen, dtype=torch.float64) * dt_scale
    A = -torch.arange(1, N + 1, dtype=torch.float64)[None].repeat(d, 1)
    y, h = ref_ssm.scan(x, dt, Bm, Cm, A)
    y0, h0 = _scan_steps(x, dt, Bm, Cm, A)
    assert torch.allclose(y.double(), y0, rtol=1e-5, atol=1e-6)
    assert torch.allclose(h.double(), h0, rtol=1e-5, atol=1e-6)


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in ("torch", "reference",
                                           "__future__", "contextlib"), \
                    (path.name, n)
