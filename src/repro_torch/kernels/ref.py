"""Plain PyTorch versions of the port's kernels.

They compute what the CUDA kernels compute, in float32 on any device.  The
CPU path of ``repro_torch.kernels.ops`` runs them, and the tests and
``chip_smoke.py`` hold each kernel against them on the card.

The kernels compute forward passes only, as the Pallas kernels they port
do.  ``flash_attention_bwd_ref``, ``mamba_scan_bwd_ref`` and
``recomputed_grads`` are the backward passes that ``ops``' autograd
functions run on the card: each recomputes the plain forward from the
saved inputs and differentiates it, as the JAX package trains through its
jnp attention and scan.

``conv1d_silu_ref`` and ``dt_softplus_ref``, the Mamba1 mixer's
coefficients, are the chain ``models.ssm`` ran in plain torch before its
kernels, op for op: in bf16 each op rounds, where the conv1d_silu kernel
rounds once.  ``moe_combine_ref`` is the chain ``models.moe`` ran for the
dropless combine before its kernel: a float32 ``index_add_`` in the sorted
order, where the kernel sums each token's rows in routing order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.spans import spanned
from repro_torch.kernels.mamba_scan import check_state

NEG_INF = -1e30
# the query rows a backward recomputes at once: its memory is one chunk's
# scores against the keys the chunk can see
BWD_Q_CHUNK = 512


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D) with ``H % Hkv == 0``.

    Dense softmax attention with scale ``D**-0.5``, the causal mask
    ``qpos >= kpos`` and, for ``window > 0``, the sliding-window mask
    ``qpos - kpos < window``.  KV stays at its native ``Hkv`` heads: the
    query heads are grouped onto it.  Returns (B, H, S, D) in q's dtype.
    """
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    if k.shape[2] != S:
        raise ValueError(f"k's length {k.shape[2]} differs from q's {S}: "
                         f"flash attention takes one sequence length")
    qg = q.float().reshape(B, Hkv, H // Hkv, S, D)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, k.float()) * (D ** -0.5)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
    return out.reshape(B, H, S, D).to(q.dtype)


@spanned("repro_torch.attn.bwd_ref")
def flash_attention_bwd_ref(q, k, v, dout, *, causal=True, window=0):
    """The gradient of ``flash_attention_ref`` at (q, k, v) against the
    output gradient ``dout`` (B, H, S, D): returns (dq, dk, dv) in q's, k's
    and v's dtypes, dk and dv at the native ``Hkv`` heads.

    The forward is recomputed ``BWD_Q_CHUNK`` query rows at a time, each
    chunk by ``models.attention.chunked_attention`` at its ``q_offset``
    against the keys it can see (up to the chunk's last row when causal,
    from its first row's window on), in float32, and differentiated; dk and
    dv sum over the chunks."""
    # imported here: models.attention imports this module through ops
    from repro_torch.models.attention import chunked_attention
    S = q.shape[2]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    with torch.enable_grad():
        for i0 in range(0, S, BWD_Q_CHUNK):
            i1 = min(i0 + BWD_Q_CHUNK, S)
            lo = max(0, i0 - window + 1) if window > 0 else 0
            hi = i1 if causal else S
            qi, ki, vi = (t.detach().float().requires_grad_()
                          for t in (q[:, :, i0:i1], k[:, :, lo:hi],
                                    v[:, :, lo:hi]))
            out = chunked_attention(qi, ki, vi, causal=causal,
                                    window=window, q_offset=i0 - lo)
            gq, gk, gv = torch.autograd.grad(
                out, (qi, ki, vi), dout[:, :, i0:i1].float())
            dq[:, :, i0:i1] = gq
            dk[:, :, lo:hi] += gk
            dv[:, :, lo:hi] += gv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def matmul_ref(a, b):
    """a: (M, K) @ b: (K, N) -> (M, N): the product in float32, cast to
    a's dtype.  On the card, float32 products run in full float32 only
    while ``torch.backends.cuda.matmul.allow_tf32`` is False (the default)."""
    return (a.float() @ b.float()).to(a.dtype)


def mamba_scan_ref(x, dt, B, C, A, D, h0=None, return_state=False):
    """Mamba1 selective scan, a sequential loop over time in float32.

    x, dt: (b, S, d); B, C: (b, S, N); A: (d, N); D: (d,).  With the state
    h (b, d, N) starting at ``h0`` ((b, d, N) float32; 0 if None), each step
    computes ``h = exp(dt_t A) h + (dt_t x_t) B_t`` and
    ``y_t = sum_n h C_t + D x_t``.  Returns y: (b, S, d) in x's dtype, and
    with ``return_state`` the pair (y, h_S), h_S the final state.
    """
    bsz, S, d = x.shape
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    A = A.float()
    if h0 is None:
        h = torch.zeros(bsz, d, B.shape[-1], dtype=torch.float32,
                        device=x.device)
    else:
        check_state(h0, x, B.shape[-1])
        h = h0
    ys = []
    for t in range(S):
        dt_t = dtf[:, t, :, None]                                   # (b, d, 1)
        h = torch.exp(dt_t * A) * h \
            + (dt_t * xf[:, t, :, None]) * Bf[:, t, None, :]
        ys.append((h * Cf[:, t, None, :]).sum(-1))
    y = (torch.stack(ys, 1) + D.float() * xf).to(x.dtype)
    return (y, h) if return_state else y


def causal_conv1d(x, w, b):
    """x: (B, S, C); w: (C, k); returns (B, S, C): the causal depthwise
    conv as a sum of k shifts, zeros before the first step, each op in x's
    type."""
    k, S = w.shape[1], x.shape[1]
    out = x * w[None, None, :, -1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[None, None, :, -1 - i]
    return out + b[None, None]


def conv1d_silu_ref(x, w, b):
    """Mamba1's conv, bias and silu: ``F.silu(causal_conv1d(x, w, b))`` in
    x's type, and its float32 widening.  Returns (y, y.float())."""
    y = F.silu(causal_conv1d(x, w, b))
    return y, y.float()


def dt_softplus_ref(p, bias):
    """Mamba1's dt: ``F.softplus(p.float() + bias)``, float32."""
    return F.softplus(p.float() + bias)


def moe_combine_ref(y, w, inv):
    """The dropless MoE's combine.  y: (T k, d), the experts' rows in the
    dispatch's sorted order; w: (T, k) float32 gates; inv: (T, k) the row
    of y of each assignment.  Returns (T, d) in y's type: each row widened
    to float32 and times its gate, the rows ``index_add_``-ed into their
    tokens in the sorted order, and the float32 sums cast once."""
    T, k = w.shape
    order = torch.empty(T * k, dtype=torch.long, device=y.device)
    order[inv.reshape(-1).long()] = torch.arange(T * k, device=y.device)
    gates = w.reshape(-1)[order]
    out = torch.zeros(T, y.shape[1], dtype=torch.float32, device=y.device)
    out.index_add_(0, order // k, y.float() * gates[:, None])
    return out.to(y.dtype)


def recomputed_grads(fn, inputs, grads):
    """The gradients of ``fn(*inputs)`` (a tensor or a tuple of them)
    against the output gradients ``grads``, the forward recomputed from
    ``inputs``: one per input, in its dtype (zeros where it plays no
    part)."""
    ins = [t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        outs = fn(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        got = torch.autograd.grad(outs, ins, grads, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for g, t in zip(got, ins))


def mamba_scan_bwd_ref(x, dt, B, C, A, D, h0, dy, dh=None):
    """The gradient of ``mamba_scan_ref(x, dt, B, C, A, D, h0,
    return_state=True)`` against the output gradients ``dy`` (of y) and
    ``dh`` (of h_S; None when h_S was not asked for): returns (dx, ddt, dB,
    dC, dA, dD, dh0), each in its input's dtype, dh0 None when h0 is None.
    The scan is recomputed from the inputs and differentiated."""
    ins = (x, dt, B, C, A, D) + (() if h0 is None else (h0,))

    def scan(*ts):
        y, h = mamba_scan_ref(*ts[:6], h0=ts[6] if h0 is not None else None,
                              return_state=True)
        return y if dh is None else (y, h)
    got = recomputed_grads(scan, ins, (dy,) if dh is None else (dy, dh))
    return (*got[:6], got[6] if h0 is not None else None)
