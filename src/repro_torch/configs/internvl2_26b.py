"""internvl2-26b [vlm] — InternLM2-20B backbone: 48L d_model=6144 48H
(GQA kv=8) d_ff=16384 vocab=92553.  The InternViT vision tower is a STUB:
the model takes precomputed patch embeddings (B, n_patches, d_model) as
``batch["patches"]``.
[arXiv:2404.16821; hf]
"""
from repro_torch.core.config import ModelConfig

FULL = ModelConfig(
    name="internvl2_26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab=92_553,
    activation="swiglu",
    rope_theta=1_000_000.0,
    n_patches=256,
)

SMOKE = ModelConfig(
    name="internvl2_smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab=256,
    activation="swiglu",
    n_patches=8,
)
