"""gemma3-1b [dense] — 26L d_model=1152 4H (kv=1) d_ff=6912 vocab=262144,
5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt]
"""
from repro_torch.core.config import ModelConfig

FULL = ModelConfig(
    name="gemma3_1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262_144,
    activation="geglu",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    window=512,              # gemma3 local window
    local_global_ratio=5,    # 5 local : 1 global
    max_seq=1_048_576,
)

SMOKE = ModelConfig(
    name="gemma3_smoke",
    family="dense",
    n_layers=3,              # exercises local/global mix (ratio 2)
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=256,
    activation="geglu",
    tie_embeddings=True,
    window=8,
    local_global_ratio=2,
)
