"""Plain float32 reference of the Mamba1 family (falcon_mamba_7b): RMS-normed
blocks of one Mamba1 mixer each (the input projection to x and the gate z;
a causal depthwise conv of width ``d_conv`` with bias over x; SiLU; the
projection to dt, B and C; dt = softplus(dt_proj + dt_bias); the selective
scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t + D x_t with
A = -exp(A_log); y SiLU-gated by z; the output projection), a final RMS
norm and an untied head.

The scan runs in chunks, in float64: inside a chunk of c steps, with L_t
the running sum of dt A, h_t = exp(L_t) (h_0 + sum_{s <= t} exp(-L_s) dt_s
B_s x_s), one cumulative sum for the whole chunk; c is kept short enough
that exp(-L) stays far inside float64's range.  So a 4k prompt takes a
few hundred tensor operations a layer, not one Python step a token."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.common import Precision, exact_float32, rmsnorm

CHUNK = 64
EXP_SPAN = 600.0    # the largest |L| a chunk may reach (float64: ~709)


def block_leaves(spec):
    """(path in a block, shape, dtype, init) of each leaf of one Mamba1
    block of the program's param tree, with the program's init (conv
    weights 0.2, ``dt_bias`` -4.6, ``A_log`` log(1..N), ``D`` 1): the
    benchmark's param maker draws them (``yardstick.weights``)."""
    m = spec["model"]
    s = m["ssm"]
    d = m["d_model"]
    d_in, N = s["expand"] * d, s["d_state"]
    r = -(-d // 16)
    bf16, f32 = torch.bfloat16, torch.float32
    return [("norm1", (d,), f32, ("fill", 1.0)),
            ("ssm/in_proj", (d, 2 * d_in), bf16, ("normal", d ** -0.5)),
            ("ssm/conv_w", (d_in, s["d_conv"]), bf16, ("normal", 0.2)),
            ("ssm/conv_b", (d_in,), bf16, ("fill", 0.0)),
            ("ssm/x_proj", (d_in, r + 2 * N), bf16, ("normal", d_in ** -0.5)),
            ("ssm/dt_proj", (r, d_in), bf16, ("normal", r ** -0.5)),
            ("ssm/dt_bias", (d_in,), f32, ("fill", -4.6)),
            ("ssm/A_log", (d_in, N), f32, ("log_range",)),
            ("ssm/D", (d_in,), f32, ("fill", 1.0)),
            ("ssm/out_proj", (d_in, d), bf16, ("normal", d_in ** -0.5))]


def scan(x, dt, Bm, Cm, A, h0=None):
    """The selective scan without D: x, dt (S, d); Bm, Cm (S, N); A (d,
    N).  Returns y (S, d) and the final state (d, N), float32."""
    S, d = x.shape
    N = A.shape[1]
    x, dt, Bm, Cm, A = (t.double() for t in (x, dt, Bm, Cm, A))
    h = torch.zeros(d, N, dtype=torch.float64, device=x.device) \
        if h0 is None else h0.double()
    step_max = float(dt.max()) * float((-A).max())
    c = max(1, min(CHUNK, int(EXP_SPAN / max(step_max, 1e-30))))
    ys = []
    for t0 in range(0, S, c):
        t1 = min(t0 + c, S)
        L = torch.cumsum(dt[t0:t1, :, None] * A[None], 0)     # (c, d, N)
        u = (dt[t0:t1] * x[t0:t1])[:, :, None] * Bm[t0:t1, None, :]
        hs = torch.exp(L) * (h[None] + torch.cumsum(torch.exp(-L) * u, 0))
        ys.append(torch.einsum("cdn,cn->cd", hs, Cm[t0:t1]))
        h = hs[-1]
    return torch.cat(ys).float(), h.float()


def forward(spec, params, tokens, positions, precision="fp32",
            layer_hook=None):
    """Logits (len(positions), V) float32 of the sequence ``tokens`` (S,)
    at ``positions``; ``layer_hook(layer, {"conv", "ssm"})`` gets each
    layer's state after the sequence, as the cache holds it: the last
    d_conv - 1 inputs of the conv (d_inner, d_conv - 1) and the scan's
    state (d_inner, N), float32."""
    m = spec["model"]
    s = m["ssm"]
    eps = spec["rms_norm_eps"]
    d_in, N, k = s["expand"] * m["d_model"], s["d_state"], s["d_conv"]
    r = -(-m["d_model"] // 16)
    prec = Precision(precision)
    S = tokens.shape[0]
    with exact_float32(), torch.no_grad():
        x = params["embed"][tokens].float()
        for li, pl in enumerate(params["layers"]):
            p = pl["ssm"]
            xz = prec.mm(rmsnorm(x, pl["norm1"], eps), p["in_proj"])
            xs, z = xz[:, :d_in], xz[:, d_in:]
            w = p["conv_w"].float()
            xc = xs * w[:, k - 1] + p["conv_b"].float()
            for i in range(1, k):
                xc[i:] += xs[:S - i] * w[:, k - 1 - i]
            xc = F.silu(xc)
            proj = prec.mm(xc, p["x_proj"])
            dt = F.softplus(prec.mm(proj[:, :r], p["dt_proj"])
                            + p["dt_bias"])
            y, h = scan(xc, dt, proj[:, r:r + N], proj[:, r + N:],
                        -torch.exp(p["A_log"].float()))
            if layer_hook is not None:
                layer_hook(li, {"conv": xs[S - (k - 1):].T, "ssm": h})
            y = (y + p["D"] * xc) * F.silu(z)
            x = x + prec.mm(y, p["out_proj"])
        x = rmsnorm(x[positions], params["final_norm"], eps)
        return prec.mm(x, params["lm_head"])
