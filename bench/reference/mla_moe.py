"""Plain float32 reference of the MLA + MoE family (deepseek_v2_lite_16b):
DeepSeek-V2's decoder.  Each block: an RMS norm, multi-head latent
attention, an RMS norm and a mixture of experts.

Attention is in the expanded form.  q is one product from the hidden state
(no q compression).  The compressed KV is c_kv, RMS-normed, beside one
rotary key part that every head shares.  Each head's keys and values come
from c_kv through ``kv_b``.  The softmax scale is ``(dn + dr)^-0.5``,
times YaRN's ``mscale(factor, mscale_all_dim)**2``.  The rotary part uses
DeepSeek-V2's YaRN frequencies, and its two halves rotate as the program
rotates them (DeepSeek rotates interleaved pairs; under random weights
that is a fixed permutation of the rope columns).

The router runs in float32 over the float32 hidden state: a softmax over
the experts, then the top k.  The gates are not renormalised where the
configuration says ``norm_topk_prob`` false.  Every routed expert runs a
SwiGLU on every token routed to it, nothing dropped, one expert's weights
converted at a time.  The shared experts are one SwiGLU of width
``n_shared * d_ff_expert``.  One request at a time, queries in blocks, so
that a 4k prompt fits beside the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.common import Precision, exact_float32, rmsnorm

Q_BLOCK = 512


def block_leaves(spec):
    """(path in a block, shape, dtype, init) of each leaf of one block of
    the program's param tree, with the program's init: the benchmark's
    param maker draws them (``yardstick.weights``)."""
    m = spec["model"]
    d, H = m["d_model"], m["n_heads"]
    a, e = m["mla"], m["moe"]
    if a.get("q_lora_rank", 0):
        raise ValueError("the reference has no q compression")
    dn, dr, dv, R = (a["qk_nope_dim"], a["qk_rope_dim"], a["v_head_dim"],
                     a["kv_lora_rank"])
    E, f = e["n_experts"], e["d_ff_expert"]
    bf16, f32 = torch.bfloat16, torch.float32
    leaves = [("norm1", (d,), f32, ("fill", 1.0)),
              ("attn/q", (d, H * (dn + dr)), bf16, ("normal", d ** -0.5)),
              ("attn/kv_a", (d, R + dr), bf16, ("normal", d ** -0.5)),
              ("attn/kv_norm", (R,), f32, ("fill", 1.0)),
              ("attn/kv_b", (R, H * (dn + dv)), bf16, ("normal", R ** -0.5)),
              ("attn/o", (H * dv, d), bf16, ("normal", (H * dv) ** -0.5)),
              ("norm2", (d,), f32, ("fill", 1.0)),
              ("moe/router", (d, E), f32, ("normal", d ** -0.5)),
              ("moe/gate", (E, d, f), bf16, ("normal", d ** -0.5)),
              ("moe/up", (E, d, f), bf16, ("normal", d ** -0.5)),
              ("moe/down", (E, f, d), bf16, ("normal", f ** -0.5))]
    if e.get("n_shared", 0):
        fs = e["n_shared"] * f
        leaves += [("moe/shared/up", (d, fs), bf16, ("normal", d ** -0.5)),
                   ("moe/shared/down", (fs, d), bf16, ("normal", fs ** -0.5)),
                   ("moe/shared/gate", (d, fs), bf16, ("normal", d ** -0.5))]
    return leaves


def _ln(v):
    return torch.tensor(float(v), dtype=torch.float64).log().item()


def _mscale(factor, mscale):
    return 1.0 if factor <= 1 else 0.1 * mscale * _ln(factor) + 1.0


def rope_scaling(spec):
    """(inv_freq (dr/2,) float64, the tables' scale, the softmax's factor)
    of the configuration: DeepSeek-V2's YaRN where ``rope_scaling`` is
    given (frequencies kept where their wavelength fits ``beta_fast``
    times into the original context, divided by ``factor`` where it fits
    under ``beta_slow`` times, a linear ramp over the indices between),
    else plain rope."""
    m = spec["model"]
    dr, theta = m["mla"]["qk_rope_dim"], m["rope_theta"]
    inv = 1.0 / theta ** (torch.arange(0, dr, 2, dtype=torch.float64) / dr)
    ys = m.get("rope_scaling")
    if not ys:
        return inv, 1.0, 1.0
    s, orig = ys["factor"], ys["original_max_position_embeddings"]

    def corr(rotations):
        return dr * _ln(orig / (rotations * 2 * torch.pi)) \
            / (2 * _ln(theta))
    low = max(int(corr(ys["beta_fast"]) // 1), 0)           # floor
    high = min(-int(-corr(ys["beta_slow"]) // 1), dr - 1)   # ceiling
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dr // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    inv = inv / s * ramp + inv * (1 - ramp)
    table = _mscale(s, ys["mscale"]) / _mscale(s, ys["mscale_all_dim"])
    soft = _mscale(s, ys["mscale_all_dim"]) ** 2 \
        if ys["mscale_all_dim"] else 1.0
    return inv, table, soft


def _rope(x, positions, inv, scale):
    """x: (S, heads, dr) float32, its two halves rotated at ``positions``
    by the frequencies ``inv``, the tables times ``scale``."""
    ang = positions.double()[:, None] * inv.to(x.device)   # (S, dr / 2)
    cos = (torch.cos(ang) * scale).float()[:, None]
    sin = (torch.sin(ang) * scale).float()[:, None]
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(q, k, v, scale, prec):
    """Causal attention of q, k (S, H, dn + dr) and v (S, H, dv), float32,
    at softmax scale ``scale``."""
    S = q.shape[0]
    q, k = prec.rows(q), prec.rows(k)
    k, v = k.transpose(0, 1), v.transpose(0, 1)            # (H, S, .)
    out = q.new_empty(S, q.shape[1], v.shape[-1])
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, S)
        s = torch.einsum("qhd,hkd->hqk", q[q0:q1], k[:, :q1]) * scale
        keep = torch.arange(q1, device=q.device)[None] \
            <= torch.arange(q0, q1, device=q.device)[:, None]
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
        out[q0:q1] = (prec.rows(p) @ prec.cols(v[:, :q1])).transpose(0, 1)
    return out


def _swiglu(h, gate, up, down, prec):
    return prec.mm(F.silu(prec.mm(h, gate)) * prec.mm(h, up), down)


def moe(spec, pm, h, prec):
    """The MoE layer of the hidden state h (T, d) float32 -> (T, d): the
    router's softmax over the experts, the top k of each token (their
    probabilities the gates, renormalised only where ``norm_topk_prob``
    is true), every expert on every token routed to it, the gated sum in
    float32, and the shared experts."""
    e = spec["model"]["moe"]
    probs = torch.softmax(prec.mm(h, pm["router"]), -1)
    w, idx = torch.topk(probs, e["top_k"], -1)
    if e.get("norm_topk_prob", True):
        w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for ex in range(e["n_experts"]):
        tok, slot = (idx == ex).nonzero(as_tuple=True)
        if tok.numel():
            y = _swiglu(h[tok], pm["gate"][ex], pm["up"][ex],
                        pm["down"][ex], prec)
            out.index_add_(0, tok, y * w[tok, slot, None])
    if "shared" in pm:
        s = pm["shared"]
        out = out + _swiglu(h, s["gate"], s["up"], s["down"], prec)
    return out


def forward(spec, params, tokens, positions, precision="fp32",
            layer_hook=None):
    """Logits (len(positions), V) float32 of the sequence ``tokens`` (S,)
    at ``positions``; ``layer_hook(layer, {"ckv", "krope"})`` gets each
    layer's c_kv after its norm (S, kv_lora_rank) and its rotary key part
    after rotation (S, qk_rope_dim), float32, as the cache holds them."""
    m = spec["model"]
    eps = spec["rms_norm_eps"]
    H = m["n_heads"]
    a = m["mla"]
    dn, dr, dv, R = (a["qk_nope_dim"], a["qk_rope_dim"], a["v_head_dim"],
                     a["kv_lora_rank"])
    inv, table, soft = rope_scaling(spec)
    scale = (dn + dr) ** -0.5 * soft
    prec = Precision(precision)
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    with exact_float32(), torch.no_grad():
        x = params["embed"][tokens].float()
        for li, pl in enumerate(params["layers"]):
            at = pl["attn"]
            h = rmsnorm(x, pl["norm1"], eps)
            q = prec.mm(h, at["q"]).view(S, H, dn + dr)
            kv = prec.mm(h, at["kv_a"])
            ckv = rmsnorm(kv[:, :R], at["kv_norm"], eps)
            krope = _rope(kv[:, None, R:], pos, inv, table)[:, 0]
            if layer_hook is not None:
                layer_hook(li, {"ckv": ckv, "krope": krope})
            kvb = prec.mm(ckv, at["kv_b"]).view(S, H, dn + dv)
            qf = torch.cat([q[..., :dn], _rope(q[..., dn:], pos, inv, table)],
                           -1)
            k = torch.cat([kvb[..., :dn], krope[:, None].expand(S, H, dr)],
                          -1)
            o = _attention(qf, k, kvb[..., dn:], scale, prec)
            x = x + prec.mm(o.reshape(S, H * dv), at["o"])
            x = x + moe(spec, pl["moe"], rmsnorm(x, pl["norm2"], eps), prec)
        x = rmsnorm(x[positions], params["final_norm"], eps)
        return prec.mm(x, params["lm_head"])
