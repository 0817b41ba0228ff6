"""Mixture of Experts: top-k routing, capacity-buffer dispatch, expert FFNs.

The JAX package's ``repro.models.moe`` on one device.  Every token is routed
to its ``top_k`` experts (float32 router, softmax, top-k, the weights
renormalised to sum to 1 unless ``MoEConfig.norm_topk_prob`` is False);
each expert takes at most ``capacity = ceil(T k cf / E)``
assignments, filled in token-major order, and drops the rest, as the
reference does.  The experts run as batched bf16 products over their
capacity buffers, and the outputs are combined in float32, one of the k
assignments after the other.  These are plain PyTorch products: the
reference computes them outside any Pallas kernel.

``moe_apply(p, x, cfg, dispatch)`` takes the reference's two dispatches:
``"gather"`` (index gather and scatter, its default) and ``"einsum"``
(one-hot dispatch and combine tensors, its baseline); with no
``dispatch`` it reads ``PerfFlags.moe_dispatch``, as the reference does.
The gather dispatch takes the reference's expert-parallel path when a mesh
is installed whose ``model`` axis is larger than 1 and divides
``n_experts`` (``_moe_ep``): each rank of ``model`` computes its share of
the experts for its batch shard, and one ``all_reduce`` over ``model``
combines them.  The shared expert stays outside that region, and the
einsum ablation stays single-shard, as in the reference.  In the train
step over a ``model`` axis the stacks are the rank's ``experts`` shard and
the same path trains: the tokens and combine weights enter the experts
through ``copy_to`` and the combine leaves through ``reduce_from``
(``dist.context``), the router stays every rank's whole, and the shared
expert runs on ``d_ff`` shards (``mlp_apply``).  Inside the
data-parallel train step (``dist.context.global_batch``) both dispatches
route the global batch from each rank's shard of it: the capacity comes
from the global token count, each rank's buffer slots follow the earlier
shards' assignments, and the aux terms are global, as the reference's jit
computes them at a ``model`` axis of 1.

With ``MoEConfig.dropless`` (the port's own option, for serving on one
device) nothing is dropped and a token's output does not depend on its
batch mates (``_moe_dropless``): the T k assignments are sorted stably by
expert, each expert's rows gathered in token order, and the three expert
products run over the experts' ragged groups, on the card as
``torch._grouped_mm`` with the groups' ends on the device (no host sync),
on the CPU as one product an expert; a float32 ``index_add_`` of gate x
row combines them.  It raises ``NotImplementedError`` under a mesh, expert
parallelism or autograd.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.core.spans import spanned
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import tp
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


def _probs(x32, router_w, top_k):
    """(logits, probs (T, E), weights (T, k), experts (T, k)) of x32 (T,
    d) float32 under the router."""
    logits = x32 @ router_w                                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, w, idx


@spanned("repro_torch.moe.route")
def _route(x32, router_w, n_experts, top_k, norm_topk_prob=True):
    """x32: (T, d) float32.  Returns (weights (T, k) float32, experts (T, k),
    aux dict): the k most probable experts of each token, most probable
    first, their probabilities (renormalised to sum to 1 with
    ``norm_topk_prob``), and the Switch-style load-balance term and the
    router z-loss."""
    logits, probs, w, idx = _probs(x32, router_w, top_k)
    if not norm_topk_prob:
        w = probs.gather(-1, idx)
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], n_experts).float().mean(0)
    aux = {"load_balance": n_experts * (me * ce).sum(),
           "router_z": (torch.logsumexp(logits, dim=-1) ** 2).mean()}
    return w, idx, aux


def _expert_counts(idx, n_experts):
    """(E,) float32: how many of ``idx``'s entries name each expert.
    ``bincount``'s, counted into a static shape, so that fake tensors
    (the dry run, ``core.hlo.analyze_step``) can trace it."""
    return torch.zeros(n_experts, dtype=torch.float32,
                       device=idx.device).index_add_(
        0, idx, torch.ones(idx.shape, dtype=torch.float32, device=idx.device))


def _route_global(x32, router_w, n_experts, top_k, axes,
                  norm_topk_prob=True):
    """``_route`` of this rank's shard x32 of a global batch over the mesh
    axes ``axes``, and (n_tokens, offset): the global token count, and (E,)
    each expert's assignments on the shards before this one (token-major
    order runs across the shards).  The aux terms are the global batch's;
    all comes from one ``all_reduce`` over ``axes``."""
    index, count = dist_ctx.shard_of(axes)
    logits, probs, w, idx = _probs(x32, router_w, top_k)
    if not norm_topk_prob:
        w = probs.gather(-1, idx)
    E, n = n_experts, x32.shape[0] * count
    table = probs.new_zeros(count, E)
    table[index] = _expert_counts(idx.reshape(-1), E)
    sums = dist_ctx.summed(torch.cat([
        probs.sum(0), (torch.logsumexp(logits, dim=-1) ** 2).sum()[None],
        _expert_counts(idx[:, 0], E),
        table.reshape(-1)]), axes)
    me, rz, ce = sums[:E] / n, sums[E] / n, sums[E + 1:2 * E + 1] / n
    offset = sums[2 * E + 1:].detach().reshape(count, E)[:index].sum(0)
    aux = {"load_balance": E * (me * ce).sum(), "router_z": rz}
    return w, idx, aux, (n, offset.long())


def _routing(x32, router_w, e):
    """``_route``'s results and (n_tokens, offset), the token count that
    sets the expert capacity and None or (E,) the assignments to each
    expert ahead of these tokens.  Under ``dist_ctx.global_batch(axes)``
    the tokens are this rank's shard of a global batch, as the reference's
    jit sees a batch sharded by the rules, and the routing is the global
    batch's (``_route_global``)."""
    axes = dist_ctx.global_batch_axes()
    if dist_ctx.shard_of(axes)[1] > 1:
        return _route_global(x32, router_w, e.n_experts, e.top_k, axes,
                             e.norm_topk_prob)
    return (*_route(x32, router_w, e.n_experts, e.top_k, e.norm_topk_prob),
            (x32.shape[0], None))


@spanned("repro_torch.moe.dispatch")
def _dispatch_indices(e_idx, n_experts, e_start, e_local, capacity,
                      offset=None):
    """Capacity-buffer coordinates for the experts ``e_start`` ..
    ``e_start + e_local - 1``.  e_idx: (T, k) expert of each assignment;
    ``offset``: None or (E,) each expert's assignments ahead of these.
    Returns:
      buf_token (e_local, capacity): the token feeding each buffer slot
        (sentinel T for an empty slot),
      slot_of (T, k): the flat buffer slot of each assignment (sentinel
        e_local * capacity for another expert's or one past capacity).
    An assignment's place in its expert's buffer is its rank among that
    expert's assignments in token-major order, after ``offset``'s."""
    T, k = e_idx.shape
    dev = e_idx.device
    flat = e_idx.reshape(-1)                               # (T*k,)
    # the one-hot is (E, T*k), so that the rank per expert is a scan along
    # the last dim: along dim 0 of a (T*k, E) one-hot the card's cumsum
    # took 6 ms a layer at 4,096 tokens (granite_moe_1b_a400m, one H100)
    onehot = torch.arange(n_experts, device=dev)[:, None] == flat[None, :]
    pos = torch.cumsum(onehot.long(), 1) - 1               # rank per expert
    pos = pos.gather(0, flat[None, :])[0]                  # (T*k,)
    if offset is not None:
        pos = pos + offset[flat]
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


@spanned("repro_torch.moe.experts")
def _expert_ffn(gate, up, down, xb):
    """xb: (E, C, d) -> (E, C, d): each expert's swiglu FFN on its buffer."""
    g = F.silu(torch.bmm(xb, gate))
    u = torch.bmm(xb, up)
    return torch.bmm(g * u, down)


def _capacity(T, e):
    return max(1, math.ceil(T * e.top_k * e.capacity_factor / e.n_experts))


@spanned("repro_torch.moe.layer")
def _moe_local(p, x, cfg: ModelConfig, e_start=0, e_local=None,
               partial=False):
    """x: (T, d) tokens.  Returns (out (T, d) float32, aux).  With
    ``e_local``, the experts ``e_start`` .. ``e_start + e_local - 1`` only
    (of ``p``'s stacks, or ``p``'s stacks where they hold just those: a
    rank's ``experts`` shard); with ``partial`` the float32 combine is this
    rank's share of expert parallelism over ``model``, its sum over the
    ranks left to the caller: the tokens and combine weights enter the
    experts through ``copy_to``, so that their gradients sum the ranks'
    experts, while the routing is every rank's whole."""
    e = cfg.moe
    T, d = x.shape
    e_local = e_local or e.n_experts
    w, idx, aux, (n, offset) = _routing(x.float(), p["router"], e)
    capacity = _capacity(n, e)
    buf_token, slot_of = _dispatch_indices(idx, e.n_experts, e_start,
                                           e_local, capacity, offset)
    if partial:
        x, w = dist_ctx.copy_to(x, "model"), dist_ctx.copy_to(w, "model")
    xpad = torch.cat([x, x.new_zeros(1, d)])
    xb = xpad[buf_token.reshape(-1)].reshape(e_local, capacity, d)
    stacks = (p[k] for k in ("gate", "up", "down"))
    if p["gate"].shape[0] != e_local:
        stacks = (s[e_start:e_start + e_local] for s in stacks)
    yb = _expert_ffn(*stacks, xb)
    ypad = torch.cat([yb.reshape(e_local * capacity, d),
                      yb.new_zeros(1, d)])
    out = torch.zeros(T, d, dtype=torch.float32, device=x.device)
    for j in range(e.top_k):
        out = out + w[:, j:j + 1] * ypad[slot_of[:, j]].float()
    return out, aux


@spanned("repro_torch.moe.dispatch")
def _sorted_rows(x, idx, n_experts):
    """x: (T, d) tokens; idx: (T, k) their experts.  Returns (order, token,
    ends, rows): the T k flat assignments sorted stably by expert (so that
    an expert's tokens stay in token order), the token of each, each
    expert's end among them (E,) int32 on the device, and the tokens' rows
    in that order (T k, d)."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    token = order // idx.shape[1]
    ends = torch.cumsum(_expert_counts(flat, n_experts), 0).to(torch.int32)
    return order, token, ends, x[token]


def _grouped_mm(rows, w, ends, bounds):
    """rows: (N, K) in groups, group e ending at ``ends[e]``; w: (E, K, M).
    Returns (N, M), each group's rows times its w[e]: ``torch._grouped_mm``
    where ``bounds`` is None, else a product a group at the host's
    ``bounds`` (``ends``' values)."""
    if bounds is None:
        return torch._grouped_mm(rows, w, offs=ends)
    out = rows.new_empty(rows.shape[0], w.shape[-1])
    start = 0
    for e, end in enumerate(bounds):
        if end > start:
            out[start:end] = rows[start:end] @ w[e]
        start = end
    return out


@spanned("repro_torch.moe.experts")
def _grouped_ffn(gate, up, down, rows, ends):
    """rows: (N, d) sorted by expert, ``ends`` (E,) each expert's end ->
    (N, d): each expert's swiglu FFN on its rows.  On the card the three
    products are grouped products over the experts' ragged groups, their
    ends read on the device; elsewhere one product an expert."""
    bounds = None if rows.is_cuda else ends.tolist()
    g = F.silu(_grouped_mm(rows, gate, ends, bounds))
    u = _grouped_mm(rows, up, ends, bounds)
    return _grouped_mm(g * u, down, ends, bounds)


@spanned("repro_torch.moe.combine")
def _combine(y, w, order, token, T):
    """(T, d) float32: each token's sum of its assignments' rows ``y`` (in
    ``order``), each times its gate in ``w`` (T, k)."""
    gates = w.reshape(-1)[order]
    out = torch.zeros(T, y.shape[1], dtype=torch.float32, device=y.device)
    return out.index_add_(0, token, y.float() * gates[:, None])


@spanned("repro_torch.moe.layer")
def _moe_dropless(p, x, cfg: ModelConfig):
    """x: (T, d) tokens.  Returns (out (T, d) float32, aux): every one of
    the T k assignments computed (no capacity), so that a token's output
    does not depend on the other tokens.  One device, no autograd."""
    e = cfg.moe
    if dist_ctx.get_mesh() is not None or tp.shard_dim(p["gate"]) == 0:
        raise NotImplementedError(
            "MoEConfig.dropless serves on one device: no mesh, no expert "
            "parallelism")
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p[k].requires_grad for k in ("router", "gate", "up", "down"))):
        raise NotImplementedError(
            "MoEConfig.dropless serves: it has no backward")
    w, idx, aux = _route(x.float(), p["router"], e.n_experts, e.top_k,
                         e.norm_topk_prob)
    order, token, ends, rows = _sorted_rows(x, idx, e.n_experts)
    y = _grouped_ffn(p["gate"], p["up"], p["down"], rows, ends)
    return _combine(y, w, order, token, x.shape[0]), aux


def _moe_ep(p, x, cfg: ModelConfig, ep_size: int):
    """Expert parallelism over the mesh's ``model`` axis, the reference's
    ``shard_map`` region as manual SPMD.  x: (B, S, d), this rank's shard of
    the batch over ``dp_axes()`` (the same on every rank of ``model``).
    Every rank routes its tokens to all experts and computes its own
    ``n_experts / ep_size`` (of ``p``'s whole stacks, or of its ``experts``
    shard in the train step over ``model``); the float32 combine is summed
    over ``model``, and the aux terms are averaged over the data axes.
    Returns the rank's output (B, S, d), its slice of the sequence under
    the sequence-sharded residual, and the aux dict."""
    B, S, d = x.shape
    dp = dist_ctx.dp_axes()
    e_local = cfg.moe.n_experts // ep_size
    e_start = dist_ctx.axis_rank("model") * e_local
    with dist_ctx.bound_axes("model", *dist_ctx.axis_names(dp)):
        out, aux = _moe_local(p, x.reshape(B * S, d), cfg, e_start, e_local,
                              partial=True)
        out = out.reshape(B, S, d)
        # the float32 combine summed over 'model' (under the
        # sequence-sharded residual, each rank keeping its slice)
        out = dist_ctx.reduce_scatter_to(out, "model", 1) \
            if dist_ctx.seq_sharded() else dist_ctx.reduce_from(out, "model")
        # make the aux scalars the same on every data shard (a global
        # batch's routing has made them so already)
        if dp and dist_ctx.global_batch_axes() is None:
            terms = dist_ctx.all_reduce(
                torch.stack([aux["load_balance"], aux["router_z"]]), dp,
                op="mean")
            aux = {"load_balance": terms[0], "router_z": terms[1]}
    return out.to(x.dtype), aux


def _moe_einsum(p, xf, cfg: ModelConfig):
    """One-hot dispatch and combine tensors (T, E, C), mesh-tensorflow
    style: the reference's baseline.  xf: (T, d)."""
    e = cfg.moe
    T = xf.shape[0]
    w, idx, aux, (n, offset) = _routing(xf.float(), p["router"], e)
    capacity = _capacity(n, e)
    onehot_e = F.one_hot(idx, e.n_experts).float()        # (T, k, E)
    pos = torch.cumsum(onehot_e.reshape(T * e.top_k, e.n_experts), 0) - 1
    if offset is not None:
        pos = pos + offset.float()
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


def _moe_capacity(p, x, cfg: ModelConfig, dispatch):
    """``moe_apply``'s routed experts through the capacity dispatches, the
    shared expert left out: (out (B, S, d), aux)."""
    dispatch = dispatch or dist_ctx.perf_flags().moe_dispatch
    if dispatch not in ("gather", "einsum"):
        raise ValueError(f"dispatch must be 'gather' or 'einsum', got "
                         f"{dispatch!r}")
    ep = dist_ctx.mesh_axis_size("model")
    # the experts' shard (the train step over 'model'), or whole stacks on
    # a mesh whose 'model' axis divides them (the inference EP path)
    shard = tp.shard_dim(p["gate"]) == 0
    # the sequence-sharded residual's tokens gathered; the experts and the
    # routing see every token of this rank's batch
    xs = tp.enter(x, False)
    B, S, d = xs.shape
    if dispatch == "gather" and (shard or (
            dist_ctx.get_mesh() is not None and ep > 1
            and cfg.moe.n_experts % ep == 0)):
        out, aux = _moe_ep(p, xs, cfg, ep)
    else:
        if dispatch == "gather":
            out, aux = _moe_local(p, xs.reshape(B * S, d), cfg)
            out = out.to(xs.dtype)
        else:
            # the one-hot ablation is single-shard, as in the reference: a
            # rank's expert shard is gathered, and every rank computes the
            # whole MoE (the gradient of its shard is its slice)
            q = dict(p)
            if shard:
                q.update({k: dist_ctx.gather_from(p[k], "model", 0)
                          for k in ("gate", "up", "down")})
            out, aux = _moe_einsum(q, xs.reshape(B * S, d), cfg)
        out = tp.leave(out.reshape(B, S, d), False)
    return out, aux


def moe_apply(p, x, cfg: ModelConfig, dispatch=None):
    """x: (B, S, d) -> (out (B, S, d), aux dict of the load-balance and
    router-z terms).  ``dispatch``: ``"gather"`` or ``"einsum"``, both the
    same function (capacity drops included); None reads
    ``PerfFlags.moe_dispatch``.  With ``MoEConfig.dropless`` neither:
    ``_moe_dropless``."""
    if cfg.moe.dropless:
        B, S, d = x.shape
        out, aux = _moe_dropless(p, x.reshape(B * S, d), cfg)
        out = out.to(x.dtype).reshape(B, S, d)
    else:
        out, aux = _moe_capacity(p, x, cfg, dispatch)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, "swiglu")
    return out, aux
