"""zamba2-2.7b [hybrid] — 54 Mamba2 blocks d_model=2560 + a SHARED attention
block (32H kv=32, d_ff=10240) inserted every 6 mamba blocks, ssm_state=64.
[arXiv:2411.15242; hf]
"""
from repro_torch.core.config import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="zamba2_2_7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10_240,
    vocab=32_000,
    activation="gelu",
    rope_theta=10_000.0,
    hybrid_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, version=2,
                  n_heads=80, head_dim=64, chunk=256),
)

SMOKE = ModelConfig(
    name="zamba2_smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    activation="gelu",
    hybrid_attn_every=2,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=2,
                  n_heads=8, head_dim=16, chunk=32),
)
