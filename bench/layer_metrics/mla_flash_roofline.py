"""The flash attention kernel's share of its roofline in MLA prefill
(bf16): ``yardstick.counts_mla_moe.mla_flash_cost``, 640 operations a
live causal pair of each head at DeepSeek-V2-Lite's widths; q and k at
qk_nope + qk_rope, v and o at v_head_dim, once."""
from layer_metrics._roofline import roofline_pct
from yardstick.counts_mla_moe import mla_flash_cost


def read(record):
    m = record["spec"]["model"]
    a = m["mla"]
    return roofline_pct(
        record, "flash_fwd",
        lambda u: mla_flash_cost(u["size"], m["n_heads"], u["n"],
                                 a["qk_nope_dim"] + a["qk_rope_dim"],
                                 a["v_head_dim"]), "bf16")
