"""The flash attention kernel's share of its roofline in prefill (bf16):
4 D operations a live causal pair of each query head; q, k, v and o once."""
from layer_metrics._roofline import roofline_pct
from yardstick.counts import flash_cost


def read(record):
    m = record["spec"]["model"]
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    return roofline_pct(
        record, "flash_fwd",
        lambda u: flash_cost(u["size"], m["n_heads"], m["n_kv_heads"],
                             u["n"], hd), "bf16")
