"""Mixture of Experts: top-k routing, capacity-buffer dispatch, expert FFNs.

The JAX package's ``repro.models.moe`` on one device.  Every token is routed
to its ``top_k`` experts (float32 router, softmax, top-k, renormalised
weights); each expert takes at most ``capacity = ceil(T k cf / E)``
assignments, filled in token-major order, and drops the rest, as the
reference does.  The experts run as batched bf16 products over their
capacity buffers, and the outputs are combined in float32, one of the k
assignments after the other.  These are plain PyTorch products: the
reference computes them outside any Pallas kernel.

``moe_apply(p, x, cfg, dispatch)`` takes the reference's two dispatches:
``"gather"`` (index gather and scatter, its default) and ``"einsum"``
(one-hot dispatch and combine tensors, its baseline); with no
``dispatch`` it reads ``PerfFlags.moe_dispatch``, as the reference does.
The reference's expert-parallel path across devices is not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.dist import context as dist_ctx
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init


def moe_init(gen, cfg: ModelConfig, *, dtype=torch.bfloat16):
    """The router (d, E) float32; the expert stacks ``gate`` and ``up`` (E,
    d, f) and ``down`` (E, f, d) in ``dtype``, each drawn with scale
    1/sqrt(in); with shared experts, a swiglu MLP of width n_shared * f."""
    e = cfg.moe
    d, dff = cfg.d_model, e.d_ff_expert

    def experts(n, in_d, out_d):
        w = torch.randn(n, in_d, out_d, generator=gen, device=gen.device,
                        dtype=torch.float32) / math.sqrt(in_d)
        return w.to(dtype)

    p = {"router": dense_init(gen, d, e.n_experts, dtype=torch.float32),
         "gate": experts(e.n_experts, d, dff),
         "up": experts(e.n_experts, d, dff),
         "down": experts(e.n_experts, dff, d)}
    if e.n_shared:
        p["shared"] = mlp_init(gen, d, e.n_shared * dff, "swiglu",
                               dtype=dtype)
    return p


def _route(x32, router_w, n_experts, top_k):
    """x32: (T, d) float32.  Returns (weights (T, k) float32, experts (T, k),
    aux dict): the k most probable experts of each token, most probable
    first, their probabilities renormalised to sum to 1, and the
    Switch-style load-balance term and the router z-loss."""
    logits = x32 @ router_w                                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], n_experts).float().mean(0)
    aux = {"load_balance": n_experts * (me * ce).sum(),
           "router_z": (torch.logsumexp(logits, dim=-1) ** 2).mean()}
    return w, idx, aux


def _dispatch_indices(e_idx, n_experts, e_start, e_local, capacity):
    """Capacity-buffer coordinates for the experts ``e_start`` ..
    ``e_start + e_local - 1``.  e_idx: (T, k) expert of each assignment.
    Returns:
      buf_token (e_local, capacity): the token feeding each buffer slot
        (sentinel T for an empty slot),
      slot_of (T, k): the flat buffer slot of each assignment (sentinel
        e_local * capacity for another expert's or one past capacity).
    An assignment's place in its expert's buffer is its rank among that
    expert's assignments in token-major order."""
    T, k = e_idx.shape
    dev = e_idx.device
    flat = e_idx.reshape(-1)                               # (T*k,)
    # the one-hot is (E, T*k), so that the rank per expert is a scan along
    # the last dim: along dim 0 of a (T*k, E) one-hot the card's cumsum
    # took 6 ms a layer at 4,096 tokens (granite_moe_1b_a400m, one H100)
    onehot = torch.arange(n_experts, device=dev)[:, None] == flat[None, :]
    pos = torch.cumsum(onehot.long(), 1) - 1               # rank per expert
    pos = pos.gather(0, flat[None, :])[0]                  # (T*k,)
    local = (flat >= e_start) & (flat < e_start + e_local) & (pos < capacity)
    n_slots = e_local * capacity
    slot_of = torch.where(local, (flat - e_start) * capacity + pos, n_slots)
    token_of = torch.arange(T * k, device=dev) // k
    # the reference scatters with mode="drop": every write aimed past the
    # buffer lands in one spare slot, cut off after
    buf_token = torch.full((n_slots + 1,), T, dtype=torch.long, device=dev)
    buf_token.scatter_(0, slot_of, torch.where(local, token_of, T))
    return buf_token[:n_slots].reshape(e_local, capacity), \
        slot_of.reshape(T, k)


def _expert_ffn(gate, up, down, xb):
    """xb: (E, C, d) -> (E, C, d): each expert's swiglu FFN on its buffer."""
    g = F.silu(torch.bmm(xb, gate))
    u = torch.bmm(xb, up)
    return torch.bmm(g * u, down)


def _capacity(T, e):
    return max(1, math.ceil(T * e.top_k * e.capacity_factor / e.n_experts))


def _moe_local(p, x, cfg: ModelConfig):
    """x: (T, d) tokens.  Returns (out (T, d) in x's dtype, aux)."""
    e = cfg.moe
    T, d = x.shape
    capacity = _capacity(T, e)
    w, idx, aux = _route(x.float(), p["router"], e.n_experts, e.top_k)
    buf_token, slot_of = _dispatch_indices(idx, e.n_experts, 0, e.n_experts,
                                           capacity)
    xpad = torch.cat([x, x.new_zeros(1, d)])
    xb = xpad[buf_token.reshape(-1)].reshape(e.n_experts, capacity, d)
    yb = _expert_ffn(p["gate"], p["up"], p["down"], xb)
    ypad = torch.cat([yb.reshape(e.n_experts * capacity, d),
                      yb.new_zeros(1, d)])
    out = torch.zeros(T, d, dtype=torch.float32, device=x.device)
    for j in range(e.top_k):
        out = out + w[:, j:j + 1] * ypad[slot_of[:, j]].float()
    return out.to(x.dtype), aux


def _moe_einsum(p, xf, cfg: ModelConfig):
    """One-hot dispatch and combine tensors (T, E, C), mesh-tensorflow
    style: the reference's baseline.  xf: (T, d)."""
    e = cfg.moe
    T = xf.shape[0]
    capacity = _capacity(T, e)
    w, idx, aux = _route(xf.float(), p["router"], e.n_experts, e.top_k)
    onehot_e = F.one_hot(idx, e.n_experts).float()        # (T, k, E)
    pos = torch.cumsum(onehot_e.reshape(T * e.top_k, e.n_experts), 0) - 1
    pos_tk = (pos.reshape(T, e.top_k, e.n_experts) * onehot_e).sum(-1)
    within = (pos_tk < capacity)[..., None].float()       # (T, k, 1)
    # one_hot of a position past capacity is all zeros, as in jax.nn.one_hot
    pos_onehot = (pos_tk[..., None] == torch.arange(
        capacity, device=xf.device)).float()              # (T, k, C)
    disp = torch.einsum("tke,tkc->tec", onehot_e * within, pos_onehot)
    comb = torch.einsum("tke,tkc,tk->tec", onehot_e * within, pos_onehot, w)
    xb = torch.einsum("tec,td->ecd", disp, xf.float()).to(xf.dtype)
    yb = _expert_ffn(p["gate"], p["up"], p["down"], xb)
    out = torch.einsum("tec,ecd->td", comb, yb.float())
    return out.to(xf.dtype), aux


def moe_apply(p, x, cfg: ModelConfig, dispatch=None):
    """x: (B, S, d) -> (out (B, S, d), aux dict of the load-balance and
    router-z terms).  ``dispatch``: ``"gather"`` or ``"einsum"``, both the
    same function (capacity drops included); None reads
    ``PerfFlags.moe_dispatch``."""
    B, S, d = x.shape
    dispatch = dispatch or dist_ctx.perf_flags().moe_dispatch
    if dispatch == "gather":
        out, aux = _moe_local(p, x.reshape(B * S, d), cfg)
    elif dispatch == "einsum":
        out, aux = _moe_einsum(p, x.reshape(B * S, d), cfg)
    else:
        raise ValueError(f"dispatch must be 'gather' or 'einsum', got "
                         f"{dispatch!r}")
    out = out.reshape(B, S, d)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, "swiglu")
    return out, aux
