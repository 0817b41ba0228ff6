"""The operation and byte counts of the MLA + MoE family
(deepseek_v2_lite_16b), computed from shapes alone, whatever implements
the work: the model's operations a call, MLA's flash attention launch,
and the routed experts' three products of one layer.  Peaks and
``least_seconds`` are ``yardstick.counts``'."""
from __future__ import annotations

_BF16 = 2


def _widths(m):
    a = m["mla"]
    return a["qk_nope_dim"], a["qk_rope_dim"], a["v_head_dim"], \
        a["kv_lora_rank"]


def projection_weights(m) -> int:
    """Weights of one block's attention products, each token through all
    of them (the expanded form): q, kv_a, kv_b and o."""
    d, H = m["d_model"], m["n_heads"]
    dn, dr, dv, R = _widths(m)
    return d * H * (dn + dr) + d * (R + dr) + R * H * (dn + dv) + H * dv * d


def pair_ops(m) -> int:
    """Operations a live (query, key) pair of a head: q.k over dn + dr and
    p.v over dv, a multiply and an add each."""
    dn, dr, dv, _ = _widths(m)
    return 2 * (dn + dr) + 2 * dv


def _matrix_flops_per_token(m) -> float:
    """2 x the weights a token multiplies in one block: the attention
    products, its top_k routed and n_shared shared experts (three
    d x d_ff_expert matrices each), and the router."""
    e, d = m["moe"], m["d_model"]
    experts = (e["top_k"] + e["n_shared"]) * 3 * d * e["d_ff_expert"]
    return 2.0 * (projection_weights(m) + experts + d * e["n_experts"])


def _pairs(first: int, n: int) -> int:
    # keys a token at position p sees: p + 1
    return n * first + n * (n + 1) // 2


def model_flops(spec, batch: int, first: int, n: int, logits: int = 1) -> float:
    """Model operations of one call on ``batch`` requests that each run n
    tokens at positions first .. first + n - 1, as
    ``yardstick.counts.model_flops`` counts them: the matrices each token
    multiplies in every block, attention's ``pair_ops`` for each live
    causal pair of each head, and the head (d_model x vocab) at the
    ``logits`` positions of each request."""
    m = spec["model"]
    per_request = m["n_layers"] * (
        n * _matrix_flops_per_token(m)
        + pair_ops(m) * m["n_heads"] * _pairs(first, n))
    head = 2.0 * m["d_model"] * m["vocab"] * logits
    return batch * (per_request + head)


def mla_flash_cost(B: int, H: int, S: int, dqk: int, dv: int):
    """(operations, bytes) of one causal MLA prefill attention of B
    requests of S tokens: 2 dqk + 2 dv operations for each live pair of
    each head; q and k at dqk, v and o at dv, bf16, each read or written
    once (the program's zero padding of v and o is not the model's
    work)."""
    ops = (2.0 * dqk + 2.0 * dv) * H * B * _pairs(0, S)
    nbytes = _BF16 * B * S * H * (2 * dqk + 2 * dv)
    return ops, nbytes


def experts_cost(assignments: int, d: int, f: int, n_experts: int):
    """(operations, bytes) of one layer's routed experts over
    ``assignments`` (T k) rows: 6 d f operations a row (gate, up and down,
    a multiply and an add each); the three expert stacks read once, the
    gathered rows in, the intermediate out and in, and the rows out, at
    bf16."""
    ops = 6.0 * d * f * assignments
    nbytes = _BF16 * (3 * n_experts * d * f + 2 * assignments * d
                      + 2 * assignments * f)
    return ops, nbytes
