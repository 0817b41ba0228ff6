"""Frozen peaks of one NVIDIA H100 SXM and the operation and byte counts of
the work the benchmark measures, computed from shapes alone.

The peaks are NVIDIA's published dense rates at the card's full 700 W: a
roofline share is stated against them, with the card's power limit beside
it.  The counts are the same whatever implements the work: a kernel that
does more, or reads an input twice, is measured against the same count.
"""
from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12

_SIZE = {"bf16": 2, "fp32": 4}


def least_seconds(ops: float, nbytes: float, precision: str) -> float:
    """The least time the card can take: the larger of the operations over
    the peak of ``precision`` and the bytes over the HBM bandwidth."""
    return max(ops / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S)


def flash_cost(B: int, H: int, Hkv: int, S: int, D: int, causal: bool = True):
    """(operations, bytes) of one causal flash attention launch at bf16:
    4 D operations (q.k and p.v, a multiply and an add each) for each live
    (query, key) pair of each query head; q and o of H heads and k and v of
    Hkv heads read or written once."""
    pairs = S * (S + 1) // 2 if causal else S * S
    ops = 4.0 * D * H * B * pairs
    nbytes = _SIZE["bf16"] * B * S * D * (2 * H + 2 * Hkv)
    return ops, nbytes


def scan_cost(b: int, S: int, d: int, N: int):
    """(operations, bytes) of one Mamba1 selective-scan launch in float32:
    10 b S d N operations (the count of ``kernels/calibrate.py::mamba_cost``
    in the program, frozen here); x, dt, y (b, S, d), B and C (b, S, N), A
    (d, N) and D (d,) read or written once, and the final state (b, d, N)
    written once, all float32 as the mixer passes them."""
    ops = 10.0 * b * S * d * N
    nbytes = _SIZE["fp32"] * (3.0 * b * S * d + 2.0 * b * S * N + d * N + d
                              + b * d * N)
    return ops, nbytes


def _matrix_flops_per_token(spec) -> float:
    """2 x the weights each token multiplies in one block."""
    m = spec["model"]
    d = m["d_model"]
    if m["family"] == "ssm":
        s = m["ssm"]
        d_in = s["expand"] * d
        dt_rank = -(-d // 16)
        N = s["d_state"]
        return 2.0 * (d * 2 * d_in + d_in * (dt_rank + 2 * N)
                      + dt_rank * d_in + d_in * d)
    hd = m.get("head_dim") or d // m["n_heads"]
    H, Hkv = m["n_heads"], m["n_kv_heads"]
    gates = 2 if m["activation"] in ("swiglu", "geglu") else 1
    return 2.0 * (d * H * hd + 2 * d * Hkv * hd + H * hd * d
                  + (gates + 1) * d * m["d_ff"])


def _mix_flops(spec, first: int, n: int) -> float:
    """Operations of the token mix of one block for one request whose n
    tokens sit at positions first .. first + n - 1: attention's 4 D for
    each live causal (query, key) pair of each head, or the Mamba1 scan's
    10 d_inner N for each token."""
    m = spec["model"]
    if m["family"] == "ssm":
        s = m["ssm"]
        return 10.0 * s["expand"] * m["d_model"] * s["d_state"] * n
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    # keys a token at position p sees: p + 1
    pairs = n * first + n * (n + 1) // 2
    return 4.0 * hd * m["n_heads"] * pairs


def model_flops(spec, batch: int, first: int, n: int, logits: int = 1) -> float:
    """Model operations of one call on ``batch`` requests that each run n
    tokens at positions first .. first + n - 1 (a prefill: first 0, n the
    prompt; a decode step: first the position, n 1): the matrices each
    token multiplies in every block, the token mix's live work, and the
    head (d_model x vocab) at the ``logits`` positions of each request
    whose logits are computed."""
    m = spec["model"]
    per_request = m["n_layers"] * (n * _matrix_flops_per_token(spec)
                                   + _mix_flops(spec, first, n))
    head = 2.0 * m["d_model"] * m["vocab"] * logits
    return batch * (per_request + head)
