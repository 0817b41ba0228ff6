"""State-space models: Mamba1, the mixer of the ssm family (falcon_mamba_7b),
and Mamba2 (SSD), the mixer of the hybrid family (zamba2_2_7b) and of the
ssm family at ``ssm.version`` 2.

The port of the reference's ``models/ssm.py``.  Three forms of Mamba1's
sequence mix, as in the reference:

  - ``scan``     : the selective scan of ``kernels.ops.mamba_scan``: the CUDA
                   kernel on the card, its plain loop on the CPU.  It takes x,
                   dt, B, C, A and D as they are and never builds the
                   (B, S, d_inner, N) decay and input tensors;
  - ``unrollU``  : U sequential steps per turn of a loop over S / U turns;
  - ``chunked``  : an associative scan inside chunks of ``ssm.chunk`` steps,
                   sequential across chunks.

``unrollU`` and ``chunked`` are plain torch forms of the same function, kept
for parity with the reference; the serving path runs ``scan``.  Types follow
the reference: projections and the causal conv in bf16, dt, B and C in
float32, x widened to float32 for the scan, the final state float32 and the
conv tail bf16.  On the card Mamba1's conv, bias and silu, and dt's bias
and softplus, run as two kernels (``kernels.ops.conv1d_silu``,
``kernels.ops.dt_softplus``): the conv's taps are summed in float32 and
rounded once to bf16, where the plain version rounds each op.

In the train step over a ``model`` axis (``dist.tp``) a mixer computes
this rank's ``d_inner`` channels (Mamba2: its heads): the scan kernel runs
on ``d_inner / model`` channels, Mamba1's row-parallel ``x_proj`` is
summed over the ranks before the scan, and the fused projections whose
contiguous shard is not this rank's channels (``in_proj``; Mamba2's
``conv_w`` and ``conv_b`` too) are gathered at use
(``_mamba1_rank_channels``, ``_mamba2_rank_heads``).

Mamba2 runs the chunked SSD in plain torch, as the reference runs it in
plain ``jnp`` (no Pallas kernel): a loop over chunks of c = min(chunk, S)
steps carries the (B, H, P, N) float32 state; inside a chunk the decay
matrix is built with its upper triangle at exp(-inf) = 0, so that an
overflowing exp above the diagonal never meets the mask as inf * 0, and
the intra-chunk product is one batched matmul over (b, h), so that no
(B, c, c, H, P) tensor is made: the largest intermediate is (B, c, c, H)
float32 (84 MB at zamba2_2_7b's width, batch 4, chunk 256).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.core.spans import span, spanned
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import tp
from repro_torch.kernels import ops
from repro_torch.kernels.ref import causal_conv1d
from repro_torch.models.layers import dense_init, norm_init, rmsnorm


# ---------------------------------------------------------------------------
# init


def mamba1_init(gen, cfg: ModelConfig, dtype=torch.bfloat16):
    """One Mamba1 mixer's params from ``gen``, with the reference's
    distributions and types: projections bf16, ``dt_bias``, ``A_log`` and
    ``D`` float32."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    dt_rank = max(1, math.ceil(d / 16))
    N = s.d_state
    dev = gen.device
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev)[None] \
        .repeat(d_in, 1)
    return {
        "in_proj": dense_init(gen, d, 2 * d_in),
        "conv_w": torch.randn(d_in, s.d_conv, generator=gen, device=dev,
                              dtype=torch.float32).to(dtype) * 0.2,
        "conv_b": torch.zeros(d_in, dtype=dtype, device=dev),
        "x_proj": dense_init(gen, d_in, dt_rank + 2 * N),
        "dt_proj": dense_init(gen, dt_rank, d_in),
        "dt_bias": torch.full((d_in,), -4.6, dtype=torch.float32, device=dev),
        "A_log": torch.log(A),
        "D": torch.ones(d_in, dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, d_in, d),
    }


def mamba2_init(gen, cfg: ModelConfig, dtype=torch.bfloat16):
    """One Mamba2 mixer's params from ``gen``, with the reference's
    distributions and types: ``in_proj`` (d, 2 d_in + 2N + H) gives z, the
    conv's input (x, B, C) and dt; the conv runs over d_in + 2N channels;
    ``A_log``, ``dt_bias`` and ``D`` (one a head) and the gate norm's
    scale are float32."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    H, N = s.n_heads, s.d_state
    assert H * s.head_dim == d_in, (H, s.head_dim, d_in)
    conv_dim = d_in + 2 * N   # conv over (x, B, C)
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d, 2 * d_in + 2 * N + H),
        "conv_w": torch.randn(conv_dim, s.d_conv, generator=gen, device=dev,
                              dtype=torch.float32).to(dtype) * 0.2,
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
        "A_log": torch.zeros(H, dtype=torch.float32, device=dev),
        "dt_bias": torch.full((H,), -4.6, dtype=torch.float32, device=dev),
        "D": torch.ones(H, dtype=torch.float32, device=dev),
        "norm": norm_init(d_in, dev),
        "out_proj": dense_init(gen, d_in, d),
    }


# ---------------------------------------------------------------------------
# causal depthwise conv (kernel k, as a sum of shifts — k is 4):
# ``kernels.ref.causal_conv1d``; Mamba1's prompt runs it with its bias and
# silu as ``kernels.ops.conv1d_silu``


def conv1d_step(x_t, conv_state, w, b):
    """x_t: (B, C); conv_state: (B, C, k-1) past inputs.  Returns (y, state)."""
    full = torch.cat([conv_state, x_t[..., None]], dim=-1)        # (B, C, k)
    y = torch.sum(full * w[None], dim=-1) + b[None]
    return y, full[..., 1:]


# ---------------------------------------------------------------------------
# mamba1 selective scan


def _ssm_coeffs1(p, xz, cfg: ModelConfig, split=False):
    s = cfg.ssm
    d_in = xz.shape[-1] // 2
    N = s.d_state
    dt_rank = p["dt_proj"].shape[0]
    x, z = xz[..., :d_in], xz[..., d_in:]
    # the conv, its bias and silu on x where xz holds it, and x widened to
    # float32 for the scan
    x, xf = ops.conv1d_silu(x, p["conv_w"], p["conv_b"])
    proj = x @ p["x_proj"]
    if split:
        # x_proj is row-parallel inside the block: dt, B and C are summed
        # over the ranks' channels, then each rank uses them for its own
        proj = dist_ctx.summed(proj, "model")
    # the bf16 product plus the float32 bias is float32, as in the reference
    dt = ops.dt_softplus(proj[..., :dt_rank] @ p["dt_proj"],
                         p["dt_bias"])                          # (B, S, d_in)
    Bm = proj[..., dt_rank:dt_rank + N].float()                 # (B, S, N)
    Cm = proj[..., dt_rank + N:].float()                        # (B, S, N)
    A = -torch.exp(p["A_log"])                                  # (d_in, N)
    return xf, z, dt, Bm, Cm, A


def _scan_unrolled(da, dbx, Cm, h, U):
    """U sequential steps per turn: the same arithmetic as one loop."""
    S = da.shape[1]
    if S % U:
        raise ValueError(f"unroll{U} needs S % {U} == 0, got S={S}")
    ys = []
    for t0 in range(0, S, U):
        for t in range(t0, t0 + U):
            h = da[:, t] * h + dbx[:, t]
            ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return torch.stack(ys, 1), h


def _assoc_scan(a, b):
    """Inclusive scan along dim 1 of the pairs (a, b) under
    ``(l, r) -> (l_a r_a, l_b r_a + r_b)``, by doubling (Hillis-Steele)."""
    k = 1
    while k < a.shape[1]:
        a, b = (torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], 1),
                torch.cat([b[:, :k], b[:, :-k] * a[:, k:] + b[:, k:]], 1))
        k *= 2
    return a, b


def _scan_chunked(da, dbx, Cm, h, c):
    """An associative scan inside chunks of c steps, sequential across
    them."""
    S = da.shape[1]
    if S % c:
        raise ValueError(f"chunked needs S % chunk == 0, got S={S}, "
                         f"chunk={c}")
    ys = []
    for t0 in range(0, S, c):
        pa, pb = _assoc_scan(da[:, t0:t0 + c], dbx[:, t0:t0 + c])
        hs = pa * h[:, None] + pb                             # (B, c, d, N)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Cm[:, t0:t0 + c]))
        h = hs[:, -1]
    return torch.cat(ys, 1), h


def mamba1_forward(p, x_seq, cfg: ModelConfig, impl="scan", state=None):
    """x_seq: (B, S, d_model) -> (out, final state dict(conv, ssm)).

    state (a carried state): dict(conv (B, d_in, k-1), ssm (B, d_in, N));
    as in the reference, only its ``ssm`` part is read.
    """
    s = cfg.ssm
    split = tp.shard_dim(p["out_proj"]) == 0
    x_seq = tp.enter(x_seq, split)
    if split:
        p = _mamba1_rank_channels(p)
    B, S, _ = x_seq.shape
    d_in = p["in_proj"].shape[1] // 2     # this rank's channels
    N = s.d_state
    xz = x_seq @ p["in_proj"]
    # conv tail = last (k-1) pre-conv inputs, for decode continuation; a
    # copy, since a view would hold the whole xz for as long as the state
    conv_tail = xz[:, -(s.d_conv - 1):, :d_in].transpose(1, 2).contiguous()
    with span("repro_torch.ssm.coeffs"):
        xf, z, dt, Bm, Cm, A = _ssm_coeffs1(p, xz, cfg, split)
    h0 = None if state is None else state["ssm"]

    if impl == "scan":
        # the kernel adds D x itself
        y, hT = ops.mamba_scan(xf, dt, Bm, Cm, A, p["D"], h0=h0,
                               return_state=True)
    else:
        da = torch.exp(dt[..., None] * A[None, None])          # (B,S,d_in,N)
        dbx = dt[..., None] * Bm[:, :, None, :] * xf[..., None]
        h = torch.zeros(B, d_in, N, dtype=torch.float32,
                        device=x_seq.device) if h0 is None else h0
        if impl.startswith("unroll"):
            y, hT = _scan_unrolled(da, dbx, Cm, h,
                                   int(impl[len("unroll"):] or 8))
        elif impl == "chunked":
            y, hT = _scan_chunked(da, dbx, Cm, h, min(s.chunk, S))
        else:
            raise ValueError(f"unknown mamba1 impl {impl!r}")
        y = y + p["D"][None, None] * xf
    with span("repro_torch.ssm.gate"):
        y = (y * F.silu(z.float())).to(x_seq.dtype)
    return tp.tp_project(y, p["out_proj"]), \
        {"ssm": hT, "conv": conv_tail.to(torch.bfloat16)}


def _mamba1_rank_channels(p):
    """Mamba1's leaves for this rank's ``d_inner`` channels, in the train
    step over ``model``.  Every leaf but one is split per channel and
    computes on its shard: ``conv_w``, ``conv_b``, ``x_proj`` (rows),
    ``dt_proj`` (columns), ``dt_bias``, ``A_log``, ``D``, ``out_proj``.
    ``in_proj`` fuses x and z side by side, so that its contiguous shard is
    x for rank 0, not half of each: it is gathered at use and this rank's
    x and z columns taken."""
    w = tp.whole(p["in_proj"], 1)
    d_in = w.shape[1] // 2
    n, r = dist_ctx.model_size(), dist_ctx.model_rank()
    k = d_in // n
    out = {name: tp.part(p[name], dim) for name, dim in (
        ("conv_w", 0), ("conv_b", 0), ("x_proj", 0), ("dt_proj", 1),
        ("dt_bias", 0), ("A_log", 0), ("D", 0))}
    out["in_proj"] = torch.cat([w[:, r * k:(r + 1) * k],
                                w[:, d_in + r * k:d_in + (r + 1) * k]], 1)
    out["out_proj"] = p["out_proj"]
    return out


def mamba1_decode(p, x_t, state, cfg: ModelConfig):
    """One-token decode.  x_t: (B, 1, d).  state: dict(conv, ssm).  On the
    rules' shards (the serving steps over ``model``) the state is this
    rank's ``d_inner`` channels, as its leaves are
    (``_mamba1_rank_channels``)."""
    s = cfg.ssm
    split = tp.shard_dim(p["out_proj"]) == 0
    x_t = tp.enter(x_t, split)
    if split:
        p = _mamba1_rank_channels(p)
    d_in = p["in_proj"].shape[1] // 2
    N = s.d_state
    dt_rank = p["dt_proj"].shape[0]
    xz = x_t[:, 0] @ p["in_proj"]
    x, z = xz[..., :d_in], xz[..., d_in:]
    xc, conv_state = conv1d_step(x, state["conv"], p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    proj = xc @ p["x_proj"]
    if split:
        proj = dist_ctx.summed(proj, "model")
    dt = F.softplus((proj[..., :dt_rank] @ p["dt_proj"]).float()
                    + p["dt_bias"])                             # (B, d_in)
    Bm = proj[..., dt_rank:dt_rank + N].float()
    Cm = proj[..., dt_rank + N:].float()
    A = -torch.exp(p["A_log"])
    xf = xc.float()
    h = torch.exp(dt[..., None] * A[None]) * state["ssm"] \
        + dt[..., None] * Bm[:, None, :] * xf[..., None]
    y = torch.einsum("bdn,bn->bd", h, Cm) + p["D"][None] * xf
    y = (y * F.silu(z.float())).to(x_t.dtype)
    return tp.tp_project(y, p["out_proj"])[:, None], \
        {"conv": conv_state, "ssm": h}


# ---------------------------------------------------------------------------
# mamba2 (SSD, chunked)


def _silu(x):
    """silu as the reference's logistic expands it: x / (1 + exp(-x)) as
    x * (1 / (1 + exp(-x))), each op rounded to x's type.  In bf16 it
    equals the reference bit for bit, where ``F.silu``, which rounds once,
    differs from it in about 4 elements of 10."""
    return x * (1 / (1 + torch.exp(-x)))


@spanned("repro_torch.ssm.ssd")
def _ssd_chunks(loga, x, Bm, Cm, dt, h, c):
    """The SSD over chunks of c steps, all float32.  loga, dt: (B, S, H);
    x: (B, S, H, P); Bm, Cm: (B, S, N); h: the starting state (B, H, P, N).
    Returns y (B, S, H, P) without the D x term, and the final state."""
    S = x.shape[1]
    tri = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    ys = []
    for t0 in range(0, S, c):
        la, xi, bi, ci, dti = (t[:, t0:t0 + c] for t in (loga, x, Bm, Cm, dt))
        cs = torch.cumsum(la, dim=1)                            # (B, c, H)
        # intra-chunk: decay L[i, j] = exp(cs_i - cs_j) for i >= j, else 0;
        # above the diagonal cs_i - cs_j >= 0 may overflow, so it is set to
        # -inf before the exp rather than masked after it (inf * 0 = NaN)
        diff = cs[:, :, None, :] - cs[:, None, :, :]            # (B, c, c, H)
        L = torch.exp(diff.masked_fill(~tri[None, :, :, None], -math.inf))
        cb = torch.einsum("bin,bjn->bij", ci, bi)               # (B, c, c)
        # sum_j cb_ij L_ijh dt_jh x_jhp as one (b, h)-batched matmul
        w = (cb[..., None] * L * dti[:, None]).permute(0, 3, 1, 2)
        y_intra = (w @ xi.transpose(1, 2)).transpose(1, 2)      # (B, c, H, P)
        # inter-chunk: the carried state's contribution, n contracted first
        y_inter = torch.einsum("bin,bhpn->bihp", ci, h) \
            * torch.exp(cs)[..., None]
        # state update
        decay_to_end = torch.exp(cs[:, -1:, :] - cs)            # (B, c, H)
        dx = dti[..., None] * xi * decay_to_end[..., None]      # (B, c, H, P)
        h = h * torch.exp(cs[:, -1])[:, :, None, None] \
            + torch.einsum("bchp,bcn->bhpn", dx, bi)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, 1), h


@spanned("repro_torch.ssm.mamba2")
def mamba2_forward(p, x_seq, cfg: ModelConfig, state=None):
    """x_seq: (B, S, d_model) -> (out, final state dict(ssm (B, H, P, N)
    float32, conv (B, d_in + 2N, k-1) bf16: the last k-1 pre-conv inputs)).

    The chunk is c = min(ssm.chunk, S), and S must be a multiple of it, as
    the reference asserts.  state (a carried state): as in the reference,
    only its ``ssm`` part is read."""
    s = cfg.ssm
    split = tp.shard_dim(p["out_proj"]) == 0
    x_seq = tp.enter(x_seq, split)
    if split:
        p = _mamba2_rank_heads(p, cfg)
    B, S, _ = x_seq.shape
    H, P, N = p["A_log"].shape[0], s.head_dim, s.d_state   # this rank's
    d_in = H * P
    c = min(s.chunk, S)
    assert S % c == 0, (S, c)

    zxbcdt = x_seq @ p["in_proj"]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * N]
    # a copy, since a view would hold the whole zxbcdt for as long as the
    # state
    conv_tail = xbc[:, -(s.d_conv - 1):].transpose(1, 2).contiguous()
    dt = F.softplus(zxbcdt[..., -H:].float() + p["dt_bias"])     # (B, S, H)
    xbc = _silu(causal_conv1d(xbc, p["conv_w"], p["conv_b"]))
    xf = xbc[..., :d_in].reshape(B, S, H, P).float()
    Bm = xbc[..., d_in:d_in + N].float()                          # (B, S, N)
    Cm = xbc[..., d_in + N:].float()                              # (B, S, N)
    A = -torch.exp(p["A_log"])                                    # (H,)
    h0 = torch.zeros(B, H, P, N, dtype=torch.float32, device=x_seq.device) \
        if state is None else state["ssm"]
    y, hT = _ssd_chunks(dt * A, xf, Bm, Cm, dt, h0, c)
    y = (y + p["D"][None, None, :, None] * xf).reshape(B, S, d_in)
    if split:
        y = _split_rmsnorm(y.to(x_seq.dtype), p["norm"],
                           s.expand * cfg.d_model)
    else:
        y = rmsnorm(y.to(x_seq.dtype), p["norm"])
    y = y.float() * F.silu(z.float())
    return tp.tp_project(y.to(x_seq.dtype), p["out_proj"]), \
        {"ssm": hT, "conv": conv_tail.to(torch.bfloat16)}


def _split_rmsnorm(y, scale, width, eps=1e-6):
    """``layers.rmsnorm`` of a row whose ``width`` channels are split over
    ``model``: y holds this rank's, and the mean square is the ranks'
    sums of squares summed."""
    y32 = y.float()
    var = dist_ctx.summed((y32 * y32).sum(-1, keepdim=True),
                          "model") / width
    return (y32 * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _mamba2_rank_heads(p, cfg: ModelConfig):
    """Mamba2's leaves for this rank's heads, in the train step over
    ``model``.  ``in_proj`` fuses z, x, B, C and dt, and ``conv_w`` /
    ``conv_b`` run over x, B and C: their contiguous shards are not this
    rank's channels, so they are gathered at use and this rank's z, x and
    dt columns taken with every rank's B and C.  ``A_log``, ``dt_bias``,
    ``D`` and the gate norm's ``norm`` are replicated: this rank's heads
    (channels) are sliced.  ``out_proj`` is split per channel (rows) and
    computes on its shard."""
    s = cfg.ssm
    d_in, N = s.expand * cfg.d_model, s.d_state
    n, r = dist_ctx.model_size(), dist_ctx.model_rank()
    k, h = d_in // n, s.n_heads // n
    dev = p["out_proj"].device

    def cols(*spans):
        return torch.cat([torch.arange(a, b, device=dev) for a, b in spans])
    mine = (r * k, (r + 1) * k)
    in_cols = cols(mine, (d_in + mine[0], d_in + mine[1]),
                   (2 * d_in, 2 * d_in + 2 * N),
                   (2 * d_in + 2 * N + r * h, 2 * d_in + 2 * N + (r + 1) * h))
    conv_cols = cols(mine, (d_in, d_in + 2 * N))
    out = {"in_proj": tp.whole(p["in_proj"], 1).index_select(1, in_cols),
           "conv_w": tp.whole(p["conv_w"], 0).index_select(0, conv_cols),
           "conv_b": tp.whole(p["conv_b"], 0).index_select(0, conv_cols),
           "norm": tp.part(p["norm"], 0), "out_proj": p["out_proj"]}
    out.update({name: tp.part(p[name], 0)
                for name in ("A_log", "dt_bias", "D")})
    return out


@spanned("repro_torch.ssm.mamba2_decode")
def mamba2_decode(p, x_t, state, cfg: ModelConfig):
    """One-token decode.  x_t: (B, 1, d).  state: dict(conv (B, d_in + 2N,
    k-1), ssm (B, H, P, N)).

    On the rules' shards (the serving steps over ``model``, ``out_proj``
    split on its rows) the rank computes its heads
    (``_mamba2_rank_heads``), and the states keep the rules' layout:
    ``conv`` is split contiguously over ``model`` where its width divides
    (not along the rank's channels: x, B and C sit side by side), else
    whole; ``ssm`` is whole (the rules do not split ``ssm_heads``).  So
    each is gathered, the rank's channels and heads taken, and the new
    whole state cut back."""
    s = cfg.ssm
    split = tp.shard_dim(p["out_proj"]) == 0
    x_t = tp.enter(x_t, split)
    d_in, P, N = s.expand * cfg.d_model, s.head_dim, s.d_state
    conv, h0 = state["conv"], state["ssm"]
    if split:
        p = _mamba2_rank_heads(p, cfg)
    H = p["A_log"].shape[0]                                 # this rank's
    k = H * P
    if split:
        r = dist_ctx.model_rank()
        conv_split = conv.shape[1] < d_in + 2 * N
        if conv_split:
            conv = dist_ctx.gather_from(conv.contiguous(), "model", 1)
        whole_conv = conv
        conv = conv.index_select(1, torch.cat([
            torch.arange(r * k, (r + 1) * k, device=conv.device),
            torch.arange(d_in, d_in + 2 * N, device=conv.device)]))
        whole_h = h0.shape[1] == s.n_heads
        if whole_h:
            h0 = h0[:, r * H:(r + 1) * H]
    zxbcdt = x_t[:, 0] @ p["in_proj"]
    z = zxbcdt[..., :k]
    xbc = zxbcdt[..., k:2 * k + 2 * N]
    dt = F.softplus(zxbcdt[..., -H:].float() + p["dt_bias"])      # (B, H)
    xc, conv_state = conv1d_step(xbc, conv, p["conv_w"], p["conv_b"])
    xc = _silu(xc)
    x = xc[..., :k].reshape(-1, H, P).float()
    Bm = xc[..., k:k + N].float()
    Cm = xc[..., k + N:].float()
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A[None])                                   # (B, H)
    h = h0 * a[..., None, None] \
        + (dt[..., None] * x)[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cm) + p["D"][None, :, None] * x
    y = y.reshape(-1, k).to(x_t.dtype)
    y = _split_rmsnorm(y, p["norm"], d_in) if split \
        else rmsnorm(y, p["norm"])
    y = y.float() * F.silu(z.float())
    if split:
        # the new whole states: every rank's x inputs, and its heads' states
        new_in = torch.cat([dist_ctx.gather_from(
            xbc[..., :k].contiguous(), "model", 1), xbc[..., k:]], 1)
        conv_state = torch.cat([whole_conv[..., 1:], new_in[..., None]], -1)
        if conv_split:
            conv_state = dist_ctx.rank_slice(conv_state, "model", 1)
        if whole_h:
            h = dist_ctx.gather_from(h.contiguous(), "model", 1)
    return tp.tp_project(y.to(x_t.dtype), p["out_proj"])[:, None], \
        {"conv": conv_state, "ssm": h}


def mamba2_whole_state(state, cfg: ModelConfig):
    """A Mamba2 block's final state (``mamba2_forward``'s) in the whole
    layout: where it was computed on the rank's heads (over ``model``),
    ``conv``'s x channels gathered ahead of B and C and ``ssm``'s heads
    gathered; else as it is."""
    s = cfg.ssm
    conv, h = state["conv"], state["ssm"]
    two_n = 2 * s.d_state
    if conv.shape[1] < s.expand * cfg.d_model + two_n:
        k = conv.shape[1] - two_n
        conv = torch.cat([dist_ctx.gather_from(conv[:, :k].contiguous(),
                                               "model", 1), conv[:, k:]], 1)
    if h.shape[1] < s.n_heads:
        h = dist_ctx.gather_from(h.contiguous(), "model", 1)
    return {"conv": conv, "ssm": h}
