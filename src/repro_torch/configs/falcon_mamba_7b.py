"""falcon-mamba-7b [ssm] — 64L d_model=4096 attention-free mamba1,
ssm_state=16, vocab=65024. [arXiv:2410.05355]
"""
from repro_torch.core.config import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="falcon_mamba_7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65_024,
    activation="silu",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=1),
)

SMOKE = ModelConfig(
    name="falcon_mamba_smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=256,
    activation="silu",
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2, version=1),
)
