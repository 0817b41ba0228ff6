"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff_expert=512
vocab=49155, MoE 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.core.config import MoEConfig, ModelConfig

FULL = ModelConfig(
    name="granite_moe_1b_a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,            # == d_ff_expert; all MLP capacity is in experts
    vocab=49_155,
    activation="swiglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=32, top_k=8, n_shared=0, d_ff_expert=512),
)

SMOKE = ModelConfig(
    name="granite_moe_smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab=256,
    activation="swiglu",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_ff_expert=32),
)
