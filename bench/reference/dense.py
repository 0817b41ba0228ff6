"""Plain float32 reference of the dense family (phi3_mini_3_8b): a decoder
of RMS-normed blocks, causal multi-head attention with rotary positions
(the two halves of the head dim rotated, theta ``rope_theta``) and a SwiGLU
MLP, a final RMS norm and an untied head.  One request at a time, layer by
layer, queries in blocks, so that a 4k prompt fits beside the program."""
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
    d, ff = m["d_model"], m["d_ff"]
    hd = m.get("head_dim") or d // m["n_heads"]
    H, Hkv = m["n_heads"], m["n_kv_heads"]
    bf16, f32 = torch.bfloat16, torch.float32
    leaves = [("norm1", (d,), f32, ("fill", 1.0)),
              ("attn/q", (d, H * hd), bf16, ("normal", d ** -0.5)),
              ("attn/k", (d, Hkv * hd), bf16, ("normal", d ** -0.5)),
              ("attn/v", (d, Hkv * hd), bf16, ("normal", d ** -0.5)),
              ("attn/o", (H * hd, d), bf16, ("normal", (H * hd) ** -0.5)),
              ("norm2", (d,), f32, ("fill", 1.0)),
              ("mlp/up", (d, ff), bf16, ("normal", d ** -0.5)),
              ("mlp/down", (ff, d), bf16, ("normal", ff ** -0.5))]
    if m["activation"] in ("swiglu", "geglu"):
        leaves.append(("mlp/gate", (d, ff), bf16, ("normal", d ** -0.5)))
    return leaves


def _rope(x, positions, theta):
    """x: (S, heads, hd) float32, rotated at ``positions``."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = positions.float()[:, None] * inv                 # (S, hd / 2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(q, k, v, prec):
    """Causal attention of q (S, H, hd) over k, v (S, Hkv, hd), float32."""
    S, H, hd = q.shape
    g = H // k.shape[1]
    q, k = prec.rows(q), prec.rows(k)
    k = k.repeat_interleave(g, 1).transpose(0, 1)          # (H, S, hd)
    v = v.repeat_interleave(g, 1).transpose(0, 1)
    out = torch.empty_like(q)
    for q0 in range(0, S, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, S)
        s = torch.einsum("qhd,hkd->hqk", q[q0:q1], k[:, :q1]) * hd ** -0.5
        keep = torch.arange(q1, device=q.device)[None] \
            <= torch.arange(q0, q1, device=q.device)[:, None]
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
        out[q0:q1] = (prec.rows(p) @ prec.cols(v[:, :q1])).transpose(0, 1)
    return out


def forward(spec, params, tokens, positions, precision="fp32",
            layer_hook=None):
    """Logits (len(positions), V) float32 of the sequence ``tokens`` (S,)
    at ``positions``; ``layer_hook(layer, {"k", "v"})`` gets each layer's
    keys after rotation and values, (Hkv, S, hd) float32, as the cache
    holds them."""
    m = spec["model"]
    eps = spec["rms_norm_eps"]
    H, Hkv = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    prec = Precision(precision)
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    with exact_float32(), torch.no_grad():
        x = params["embed"][tokens].float()
        for li, pl in enumerate(params["layers"]):
            a = pl["attn"]
            h = rmsnorm(x, pl["norm1"], eps)
            q = _rope(prec.mm(h, a["q"]).view(S, H, hd), pos, m["rope_theta"])
            k = _rope(prec.mm(h, a["k"]).view(S, Hkv, hd), pos,
                      m["rope_theta"])
            v = prec.mm(h, a["v"]).view(S, Hkv, hd)
            if layer_hook is not None:
                layer_hook(li, {"k": k.transpose(0, 1),
                                "v": v.transpose(0, 1)})
            x = x + prec.mm(_attention(q, k, v, prec).reshape(S, H * hd),
                            a["o"])
            h = rmsnorm(x, pl["norm2"], eps)
            mlp = pl["mlp"]
            x = x + prec.mm(F.silu(prec.mm(h, mlp["gate"]))
                            * prec.mm(h, mlp["up"]), mlp["down"])
        x = rmsnorm(x[positions], params["final_norm"], eps)
        return prec.mm(x, params["lm_head"])
