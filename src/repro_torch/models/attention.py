"""Attention: GQA/MQA with causal and sliding-window masks, cross-attention
(whisper's decoder) and DeepSeek's multi-head latent attention (MLA).

Prefill self-attention goes through
``repro_torch.kernels.ops.flash_attention``: the CUDA flash kernel on the
card, its plain version on the CPU.  That holds for every self-attention
of every family: causal decoders, whisper's non-causal encoder,
InternVL2's prompt of image patches and tokens.  MLA's
prefill takes it too, at q/k head dim ``qk_nope + qk_rope`` with v
zero-padded to that width and sliced back, as the JAX package hands its
chunked attention the same shapes.

Cross-attention (queries from the decoder, keys and values from the
encoder's output, so that q and kv have different lengths) runs in plain
PyTorch on both devices, in ``chunked_attention``.  The Pallas kernel the
flash kernel ports takes one sequence length for q and kv, and the JAX
package computes cross-attention in its jnp ``chunked_attention``, outside
any Pallas kernel; the CUDA wrapper refuses a k whose length differs from
q's, so a cross-attention sent to it raises.  Decode attention (one query
against the cache, or against the encoder's keys; MLA's in the compressed
space) is plain PyTorch too, as the JAX package computes it outside any
Pallas kernel.

In the train step over a ``model`` axis (``dist.tp``) the query heads
are this rank's shard of them, and the local head counts come from the
weights' widths: the flash kernel runs on this rank's heads, their KV
heads split alongside or, too few to split, cut to those its query heads
use.  MLA's compressed KV (``kv_a``, ``kv_norm``) is every rank's whole.

In the serving steps on the rules' shards (``serve.step``) decode computes
on this rank's shards of the weights and of the cache, in each layout the
rules give it (``gqa_decode``, ``mla_decode``'s ``seq``): KV heads over
``model``; ``head_dim`` over ``model`` where the KV heads are too few
(every rank's partial q.k summed, P.V on its slice, the slices gathered);
``kv_seq`` over ``data`` (flash-decoding: the scores' max and the
exponentials' sums combined over the ranks, ``_attend``).

Under ``PerfFlags.windowed_attention`` a local layer takes a static window
(``static_window``).  In prefill and training the card runs the flash
kernel with its window mask, which skips every KV tile before the window,
so its work is O(S window) as the reference's ``windowed_attention``; the
CPU runs ``windowed_attention``, the reference's plain path.  In decode the
query reads only the window-sized slice of the cache (on the rules' shards,
the part of that slice which lies in the rank's positions).
``PerfFlags.attn_remat_chunk`` checkpoints ``chunked_attention``'s body per
KV chunk, so that its backward recomputes each chunk's scores.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import ModelConfig
from repro_torch.core.spans import spanned
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import tp
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense_init, norm_init,
                                       rmsnorm, yarn_softmax_factor)

NEG_INF = -1e30


def attn_init(gen, cfg: ModelConfig, *, dtype=torch.bfloat16):
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "q": dense_init(gen, d, H * (m.qk_nope_dim + m.qk_rope_dim),
                            dtype=dtype),
            "kv_a": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_dim,
                               dtype=dtype),
            "kv_norm": norm_init(m.kv_lora_rank, gen.device),
            "kv_b": dense_init(gen, m.kv_lora_rank,
                               H * (m.qk_nope_dim + m.v_head_dim),
                               dtype=dtype),
            "o": dense_init(gen, H * m.v_head_dim, d, dtype=dtype),
        }
    return {
        "q": dense_init(gen, d, H * hd, dtype=dtype),
        "k": dense_init(gen, d, Hkv * hd, dtype=dtype),
        "v": dense_init(gen, d, Hkv * hd, dtype=dtype),
        "o": dense_init(gen, H * hd, d, dtype=dtype),
    }


def _rope_heads(x, cos, sin):
    """x: (B, H, S, D); cos/sin: (S, D/2), or (1, D/2) for decode."""
    return apply_rope(x, cos[None, None], sin[None, None])


@spanned("repro_torch.attn.chunked")
def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      kv_valid=None, chunk=512):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Skv, D) with ``H % Hkv == 0``.
    Returns (B, H, Sq, D) in q's dtype.

    The JAX package's online-softmax attention over KV chunks, in float32:
    KV is zero-padded to a multiple of ``chunk`` (at most Skv) and the
    padded keys masked (``kv_valid``, default Skv), query i sits at
    position ``q_offset + i``, and ``window > 0`` masks keys ``window`` or
    more behind the query (``window < 0`` masks keys more than the padded
    Skv + Sq behind, as the reference does).  Query heads are grouped onto
    the native ``Hkv`` KV heads."""
    B, H, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    scale = D ** -0.5
    chunk = min(chunk, Skv)
    if Skv % chunk:   # pad KV to a chunk multiple; padded keys are masked
        pad = chunk - Skv % chunk
        k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
        if kv_valid is None:
            kv_valid = Skv
        Skv += pad
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    qf = q.float().reshape(B, Hkv, H // Hkv, Sq, D)

    def body(m, l, acc, k_i, v_i, i):
        k_pos = i * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf, k_i.float()) * scale
        mask = torch.ones(Sq, chunk, dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window:
            w_eff = window if window > 0 else Sq + Skv + 1
            mask &= (q_pos[:, None] - k_pos[None, :]) < w_eff
        if kv_valid is not None:
            mask &= (k_pos < kv_valid)[None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] \
            + torch.einsum("bkgqc,bkcd->bkgqd", p, v_i.float())
        return m_new, l, acc

    step = body
    if dist_ctx.perf_flags().attn_remat_chunk and torch.is_grad_enabled():
        # flash-style backward: recompute each chunk's (Sq, chunk) scores
        # rather than keep them for every chunk
        def step(*args):
            return checkpoint(body, *args, use_reentrant=False)
    m = torch.full((B, Hkv, H // Hkv, Sq), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for i in range(Skv // chunk):
        m, l, acc = step(m, l, acc, k[:, :, i * chunk:(i + 1) * chunk],
                         v[:, :, i * chunk:(i + 1) * chunk], i)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, Sq, D).to(q.dtype)


def windowed_attention(q, k, v, *, window: int, chunk: int = 512,
                       q_offset=0):
    """Causal sliding-window attention with a static window, the
    reference's O(S window) path for local layers: each query chunk attends
    only to its own and the previous KV chunk, so it needs ``window <=
    chunk``.  q: (B, H, Sq, D); k, v: (B, Hkv, Skv, D) with Sq == Skv and
    ``Sq % min(chunk, Sq) == 0``.  Returns (B, H, Sq, D) in q's dtype,
    computed in float32 with the query heads grouped onto the native Hkv
    heads."""
    B, H, Sq, D = q.shape
    Hkv = k.shape[1]
    assert window <= chunk, (window, chunk)
    chunk = min(chunk, Sq)
    assert Sq % chunk == 0
    scale = D ** -0.5
    # one chunk of zeros on the left, so that every query chunk sees two
    kp = F.pad(k, (0, 0, chunk, 0)).float()
    vp = F.pad(v, (0, 0, chunk, 0)).float()
    qg = q.float().reshape(B, Hkv, H // Hkv, Sq, D)
    outs = []
    for j in range(Sq // chunk):
        k_j = kp[:, :, j * chunk:(j + 2) * chunk]
        v_j = vp[:, :, j * chunk:(j + 2) * chunk]
        q_pos = q_offset + j * chunk + torch.arange(chunk, device=q.device)
        k_pos = q_offset + (j - 1) * chunk \
            + torch.arange(2 * chunk, device=q.device)
        s = torch.einsum("bkgqd,bkcd->bkgqc",
                         qg[:, :, :, j * chunk:(j + 1) * chunk], k_j) * scale
        mask = (q_pos[:, None] >= k_pos[None, :]) \
            & ((q_pos[:, None] - k_pos[None, :]) < window) \
            & (k_pos >= 0)[None, :]
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqc,bkcd->bkgqd", p, v_j).to(q.dtype))
    return torch.cat(outs, 3).reshape(B, H, Sq, D)


@spanned("repro_torch.attn.decode")
def decode_attention(q, k_cache, v_cache, *, pos, window=0, k_pos=None,
                     dim_split=False, seq=None):
    """Single-token decode.  q: (B, H, 1, D); caches: (B, Hkv, S, D).

    Keys at a position > ``pos`` are masked, and for ``window > 0`` so are
    keys ``window`` or more behind ``pos``.  ``k_pos``: the positions of
    the cache's rows when it is a slice (the static-window path); default
    ``arange(S)`` from the rank's first position.  Query heads are grouped
    onto the native ``Hkv`` KV heads.

    On a cache sharded by the rules: ``dim_split``, D is this rank's slice
    of the head dim over ``model`` (and q's the same slice): the partial
    q.k of the slices are summed over ``model`` before the softmax, and the
    output's slices gathered after P.V.  ``seq``: None or (mesh axes,
    start), the rows being this rank's positions from ``start``
    (``_attend``)."""
    B, H, _, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    qg = q[:, :, 0].float().reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float())
    if dim_split:
        s = dist_ctx.all_reduce(s.contiguous(), "model")
        D = D * dist_ctx.model_size()
    s = s * (D ** -0.5)
    if k_pos is None:
        k_pos = (seq[1] if seq else 0) + torch.arange(S, device=q.device)
    mask = k_pos <= pos
    if window > 0:
        mask &= (pos - k_pos) < window
    out = _attend(s, mask, lambda w: torch.einsum(
        "bkgs,bksd->bkgd", w, v_cache.float()), seq)
    if dim_split:
        out = dist_ctx.gather_from(out.contiguous(), "model", -1)
    return out.reshape(B, H, 1, -1).to(q.dtype)


def gqa_forward(p, x, cos, sin, *, cfg: ModelConfig, causal=True, window=0,
                xa=None, static_window=None):
    """Full-sequence (prefill and training) attention.  Returns (out, (k,
    v)) with k, v of shape (B, Hkv, Skv, hd) after RoPE.

    Self-attention (``xa`` None) runs on the flash kernel.  With
    ``static_window``, causal self-attention over that window: the flash
    kernel's window mask on the card, ``windowed_attention`` on the CPU.
    With ``xa``, the encoder's output (B, Skv, d), it is cross-attention: k
    and v come from ``xa``, with no RoPE and no causal mask, through
    ``chunked_attention`` (see the module docstring)."""
    hd = cfg.resolved_head_dim
    split = tp.shard_dim(p["q"]) == 1
    whole_kv = split and tp.shard_dim(p["k"]) != 1
    x = tp.enter(x, split)
    wk, wv = p["k"], p["v"]
    if split:
        if xa is not None:
            xa = dist_ctx.copy_to(xa)
        if whole_kv:
            # too few KV heads to split (MQA): each rank computes them all
            # and uses its query heads' one; their gradients are summed
            wk, wv = dist_ctx.copy_to(wk), dist_ctx.copy_to(wv)
    B, S, _ = x.shape
    # this rank's heads: the weights' widths (all of them off a mesh)
    H, Hkv = p["q"].shape[1] // hd, wk.shape[1] // hd
    kv_src = x if xa is None else xa
    Skv = kv_src.shape[1]
    q = (x @ p["q"]).reshape(B, S, H, hd).transpose(1, 2)
    k = (kv_src @ wk).reshape(B, Skv, Hkv, hd).transpose(1, 2)
    v = (kv_src @ wv).reshape(B, Skv, Hkv, hd).transpose(1, 2)
    if xa is None and cos is not None:
        q = _rope_heads(q, cos, sin)
        k = _rope_heads(k, cos, sin)
    kv = (k, v)     # every KV head this rank computed: what a cache keeps
    if whole_kv:
        k, v = _kv_of_rank_heads(k, v, H, cfg.n_heads)
    if xa is not None:
        out = chunked_attention(q, k, v, causal=False, window=window)
    elif static_window and q.device.type == "cpu":
        out = windowed_attention(q, k, v, window=static_window)
    else:
        out = ops.flash_attention(q, k, v,
                                  causal=causal or bool(static_window),
                                  window=static_window or window)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return tp.tp_project(out, p["o"]), kv


def _kv_of_rank_heads(k, v, h_local, h_total):
    """k, v (B, Hkv, S, D), all the KV heads (too few to split over
    ``model``), cut to the one that this rank's ``h_local`` query heads (of
    ``h_total``) attend to.  Where the KV heads do not divide over
    ``model``, neither do the query heads of one group divide the rank's:
    they share one KV head (MQA; at model 16 also tinyllama's, granite's
    and internvl2's GQA)."""
    group = h_total // k.shape[1]
    if group % h_local:
        raise NotImplementedError(
            f"{h_local} query heads a rank across KV groups of {group}")
    kv = dist_ctx.model_rank() * h_local // group
    return k[:, kv:kv + 1], v[:, kv:kv + 1]


def _attend(s, mask, weigh, seq=None):
    """softmax(s masked to ``mask``) applied by ``weigh`` (the weighted sum
    of the values, ``weigh(w)``).  ``seq``: None, or (mesh axes, start) where
    the cache rows behind ``s`` are this rank's slice of the positions over
    those axes: flash-decoding, the scores' max over the ranks by one
    all-reduce, then each rank's sum of exponentials and weighted values
    summed by one more."""
    s = s.masked_fill(~mask, NEG_INF)
    if seq is None:
        return weigh(torch.softmax(s, dim=-1))
    # a rank may hold none of a static window's rows
    mx = s.amax(-1) if s.shape[-1] else s.new_full(s.shape[:-1], NEG_INF)
    mx = dist_ctx.all_reduce(mx.contiguous(), seq[0], op="max")
    e = torch.exp(s - mx[..., None]) * mask
    acc = weigh(e)
    both = dist_ctx.all_reduce(torch.cat(
        [e.sum(-1).reshape(-1), acc.reshape(-1)]), seq[0])
    n = mx.numel()
    return both[n:].reshape(acc.shape) \
        / both[:n].reshape(mx.shape + (1,) * (acc.dim() - mx.dim()))


def _put_token(cache, new, pos, seq, dim=2):
    """Writes ``new`` (one position along ``dim``) into ``cache`` at
    ``pos``, where this rank holds that position (``seq``: its rows along
    ``dim`` are its slice of the positions from ``seq[1]``)."""
    at = pos - (seq[1] if seq else 0)
    if 0 <= at < cache.shape[dim]:
        cache.narrow(dim, at, 1).copy_(new)


def gqa_decode(p, x, cache_k, cache_v, cos, sin, *, cfg: ModelConfig, pos,
               window=0, xa_kv=None, static_window=None, seq=None):
    """One-token decode.  x: (B, 1, d); cache_[kv]: (B, Hkv, S, hd).

    Writes this token's k and v into the caches IN PLACE at ``pos`` (the JAX
    package returns updated copies) and returns (out, cache_k, cache_v).
    With ``static_window`` the query reads only the window-sized slice of
    the cache that ends at ``pos`` (clamped into the cache).  With
    ``xa_kv``, the encoder's precomputed (k, v) (B, Hkv, Skv, hd), it is
    cross-attention: the query attends to every encoder position and the
    caches are returned untouched.

    On the rules' shards (the serving steps over a mesh) the weights are
    this rank's shards (``dist.tp`` marks; the head counts come from their
    widths, as in ``gqa_forward``) and the caches the rank's shards in the
    rules' layout, ``seq`` None or (mesh axes, start) of their positions:

      KV heads over ``model``: the rank's heads attend to its KV heads;
      ``head_dim`` over ``model`` (too few KV heads to split): every rank
        takes all the query heads (gathered where the rank computed its
        own), the partial q.k of its slice of head_dim summed over
        ``model``, P.V on the slice, the slices gathered, then its own
        heads again (``decode_attention``'s ``dim_split``);
      all KV heads on every rank, query heads split: the rank's heads
        attend to their KV heads;
      ``kv_seq`` over ``data`` (``seq``): flash-decoding over the ranks'
        positions, the static window's slice cut to the rank's.
    The output projection closes the region (``tp.tp_project``)."""
    hd = cfg.resolved_head_dim
    B = x.shape[0]
    q_split = tp.shard_dim(p["q"]) == 1
    x = tp.enter(x, q_split)
    H = p["q"].shape[1] // hd
    q = (x @ p["q"]).reshape(B, 1, H, hd).transpose(1, 2)
    k_c, v_c = (cache_k, cache_v) if xa_kv is None else xa_kv
    dim_split = k_c.shape[3] < hd
    if xa_kv is None:
        Hkv = p["k"].shape[1] // hd
        k_new = (x @ p["k"]).reshape(B, 1, Hkv, hd).transpose(1, 2)
        v_new = (x @ p["v"]).reshape(B, 1, Hkv, hd).transpose(1, 2)
        if cos is not None:
            q = _rope_heads(q, cos, sin)
            k_new = _rope_heads(k_new, cos, sin)
        if dim_split:
            k_new = dist_ctx.rank_slice(k_new, "model", 3)
            v_new = dist_ctx.rank_slice(v_new, "model", 3)
        _put_token(cache_k, k_new, pos, seq)
        _put_token(cache_v, v_new, pos, seq)
        at = pos
    else:
        seq, at = None, k_c.shape[2] - 1
    gathered = dim_split and q_split
    if gathered:
        q = dist_ctx.gather_from(q.contiguous(), "model", 1)
    elif q_split and k_c.shape[1] == cfg.n_kv_heads:
        # every KV head here: this rank's query heads take theirs
        group = cfg.n_heads // cfg.n_kv_heads
        lo = dist_ctx.model_rank() * H // group
        hi = ((dist_ctx.model_rank() + 1) * H - 1) // group + 1
        k_c, v_c = k_c[:, lo:hi], v_c[:, lo:hi]
    if dim_split:
        q = dist_ctx.rank_slice(q, "model", 3)
    k_pos = None
    if static_window:
        # the window's slice of the whole cache, then the part of it in
        # this rank's rows (all of it off a kv_seq split)
        first, n = (seq[1] if seq else 0), k_c.shape[2]
        total = n * (dist_ctx.shard_of(seq[0])[1] if seq else 1)
        w = min(static_window, total)
        start = min(max(pos - w + 1, 0), total - w)
        lo = min(max(start - first, 0), n)
        hi = min(max(start + w - first, 0), n)
        k_c, v_c = k_c[:, :, lo:hi], v_c[:, :, lo:hi]
        k_pos = first + torch.arange(lo, hi, device=x.device)
    out = decode_attention(q, k_c, v_c, pos=at, window=window, k_pos=k_pos,
                           dim_split=dim_split, seq=seq)
    if gathered:
        out = dist_ctx.rank_slice(out, "model", 1)
    out = out.transpose(1, 2).reshape(B, 1, H * hd)
    return tp.tp_project(out, p["o"]), cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (DeepSeek V2): a compressed KV cache


def mla_forward(p, x, cos, sin, *, cfg: ModelConfig):
    """Prefill MLA in the naive (expanded) form.  x: (B, S, d); cos/sin of
    ``qk_rope_dim``.  RoPE turns q's rope part and the one key rope part
    that all heads share; k is (k_nope, k_rope) per head and v is padded
    with zeros from ``v_head_dim`` to the q/k width for the flash kernel,
    whose output is sliced back.  Under ``cfg.rope_scaling`` (YaRN) q is
    multiplied by ``yarn_softmax_factor`` before the kernel, which scales
    by ``(dn + dr)^-0.5``.  Returns (out, (c_kv (B, S, lora), k_rope (B,
    S, dr))) for the cache."""
    m = cfg.mla
    dn, dr, dv, R = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, m.kv_lora_rank
    split = tp.shard_dim(p["q"]) == 1
    x = tp.enter(x, split)
    kv_a, kv_norm, kv_b = p["kv_a"], p["kv_norm"], p["kv_b"]
    if split:
        # the compressed KV is every head's: each rank computes it whole and
        # its gradients are summed; kv_b is per head (contiguous), so its
        # shard is this rank's heads
        kv_a, kv_norm = dist_ctx.copy_to(kv_a), dist_ctx.copy_to(kv_norm)
        kv_b = tp.part(kv_b, 1)
    B, S, _ = x.shape
    H = p["q"].shape[1] // (dn + dr)     # this rank's heads
    q = (x @ p["q"]).reshape(B, S, H, dn + dr).transpose(1, 2)
    kv = x @ kv_a
    c_kv = rmsnorm(kv[..., :R], kv_norm)
    q_rope = _rope_heads(q[..., dn:], cos, sin)
    k_rope = _rope_heads(kv[:, None, :, R:], cos, sin)[:, 0]   # (B, S, dr)
    kvb = (c_kv @ kv_b).reshape(B, S, H, dn + dv).transpose(1, 2)
    k = torch.cat([kvb[..., :dn], k_rope[:, None].expand(B, H, S, dr)], -1)
    qf = torch.cat([q[..., :dn], q_rope], -1)
    # the kernel scales by (dn + dr)^-0.5; YaRN's factor rides on q
    factor = yarn_softmax_factor(cfg.rope_scaling)
    if factor != 1.0:
        qf = qf * factor
    v = F.pad(kvb[..., dn:], (0, dn + dr - dv))
    out = ops.flash_attention(qf, k, v, causal=True)[..., :dv]
    out = out.transpose(1, 2).reshape(B, S, H * dv)
    return tp.tp_project(out, p["o"]), (c_kv, k_rope)


def mla_decode(p, x, cache_ckv, cache_krope, cos, sin, *, cfg: ModelConfig,
               pos, seq=None):
    """One-token MLA decode in the absorbed form: attention runs in the
    compressed space, in float32, at the softmax scale ``(dn + dr)^-0.5``
    times ``yarn_softmax_factor``.  x: (B, 1, d); cache_ckv: (B, S, lora);
    cache_krope: (B, S, dr).  Writes this token's c_kv and k_rope into the
    caches IN PLACE at ``pos`` and returns (out, cache_ckv, cache_krope).
    On the rules' shards (the serving steps) the query heads and ``kv_b``
    are this rank's heads, the compressed cache every head's, and ``seq``
    None or (mesh axes, start) of the cache's positions (``_attend``)."""
    m = cfg.mla
    B = x.shape[0]
    dn, dr, dv, R = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, m.kv_lora_rank
    split = tp.shard_dim(p["q"]) == 1
    x = tp.enter(x, split)
    kv_b = tp.part(p["kv_b"], 1) if split else p["kv_b"]
    H = p["q"].shape[1] // (dn + dr)     # this rank's heads
    scale = (dn + dr) ** -0.5 * yarn_softmax_factor(cfg.rope_scaling)
    q = (x @ p["q"]).reshape(B, 1, H, dn + dr).transpose(1, 2)
    q_nope, q_rope = q[..., :dn], _rope_heads(q[..., dn:], cos, sin)
    kv = x @ p["kv_a"]
    c_new = rmsnorm(kv[..., :R], p["kv_norm"])             # (B, 1, R)
    kr_new = _rope_heads(kv[:, None, :, R:], cos, sin)[:, 0]
    _put_token(cache_ckv, c_new, pos, seq, dim=1)
    _put_token(cache_krope, kr_new, pos, seq, dim=1)
    wkb = kv_b.reshape(R, H, dn + dv).float()
    w_k, w_v = wkb[..., :dn], wkb[..., dn:]
    ckv = cache_ckv.float()
    q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, :, 0].float(), w_k)
    s = (torch.einsum("bhr,bsr->bhs", q_c, ckv)
         + torch.einsum("bhd,bsd->bhs", q_rope[:, :, 0].float(),
                        cache_krope.float())) * scale
    mask = (seq[1] if seq else 0) \
        + torch.arange(cache_ckv.shape[1], device=x.device) <= pos
    ctx_c = _attend(s, mask, lambda w: torch.einsum("bhs,bsr->bhr", w, ckv),
                    seq)
    out = torch.einsum("bhr,rhv->bhv", ctx_c, w_v)
    out = out.reshape(B, 1, H * dv).to(x.dtype)
    return tp.tp_project(out, p["o"]), cache_ckv, cache_krope
