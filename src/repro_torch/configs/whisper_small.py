"""whisper-small [audio] — enc-dec transformer backbone, conv frontend stub.

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865. [arXiv:2212.04356]
The audio frontend (mel + 2x conv) is a STUB: the model takes precomputed
frame embeddings of shape (B, 1500, d_model) as ``batch["frames"]``.
"""
from repro_torch.core.config import EncoderConfig, ModelConfig

FULL = ModelConfig(
    name="whisper_small",
    family="encdec",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51_865,
    activation="gelu",
    norm="layernorm",
    tie_embeddings=True,
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
    encoder=EncoderConfig(n_layers=12, n_ctx=1500),
)

SMOKE = ModelConfig(
    name="whisper_small_smoke",
    family="encdec",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    activation="gelu",
    norm="layernorm",
    tie_embeddings=True,
    rope_theta=0.0,
    encoder=EncoderConfig(n_layers=2, n_ctx=16),
)
