"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000, llama2-style. [arXiv:2401.02385; hf]
"""
from repro_torch.core.config import ModelConfig

FULL = ModelConfig(
    name="tinyllama_1_1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32_000,
    activation="swiglu",
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="tinyllama_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab=256,
    activation="swiglu",
)
