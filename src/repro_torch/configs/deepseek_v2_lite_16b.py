"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H MLA(kv_lora=512)
d_ff_expert=1408, 64 routed experts top-6 + 2 shared. [arXiv:2405.04434; hf]

DeepSeek-V2 in full has 160 routed experts; V2-Lite, the model named here,
has 64 routed + 2 shared, top-6 (HF config), which this config follows.
As in the JAX package, every one of the 27 layers is an MoE layer: HF's
dense MLP in the first layer is not part of this config.
"""
from repro_torch.core.config import MLAConfig, MoEConfig, ModelConfig

FULL = ModelConfig(
    name="deepseek_v2_lite_16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102_400,
    activation="swiglu",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
)

SMOKE = ModelConfig(
    name="deepseek_v2_lite_smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=48,
    vocab=256,
    activation="swiglu",
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_ff_expert=48),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
)
