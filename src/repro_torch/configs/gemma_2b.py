"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256. [arXiv:2403.08295; hf]
"""
from repro_torch.core.config import ModelConfig

FULL = ModelConfig(
    name="gemma_2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab=256_000,
    activation="geglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="gemma_2b_smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab=256,
    activation="geglu",
    tie_embeddings=True,
)
