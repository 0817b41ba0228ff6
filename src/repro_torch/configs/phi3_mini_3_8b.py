"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064, RoPE + SwiGLU. [arXiv:2404.14219]
"""
from repro_torch.core.config import ModelConfig

FULL = ModelConfig(
    name="phi3_mini_3_8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32_064,
    activation="swiglu",
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="phi3_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab=256,
    activation="swiglu",
)
