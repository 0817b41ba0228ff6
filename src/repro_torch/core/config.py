"""Model configuration: the port's own copy of the reference's ``ModelConfig``.

Every architecture is described by a frozen ``ModelConfig`` with the same
fields, defaults and meaning as the JAX package's, so a config file reads the
same in both packages.  The port adds options of its own, each defaulting to
the JAX package's behaviour: ``MoEConfig.norm_topk_prob`` and
``MoEConfig.dropless`` (``models.moe``), and ``ModelConfig.rope_scaling``, a
``YarnConfig`` (``models.transformer._rope_for``, ``models.attention``'s
MLA).  A sub-config may be given as a dict of its fields, as a JSON file
holds it; ``ModelConfig`` turns it into its dataclass.  The registry in
``repro_torch.configs`` maps ``--arch <id>`` strings to full and reduced
(smoke) configs.  ``SHAPES`` are the reference's workload shapes (sequence
length, global batch, kind), which the training launcher takes by name.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0          # routed experts
    top_k: int = 0
    n_shared: int = 0           # shared (always-on) experts
    d_ff_expert: int = 0        # per-expert hidden dim
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    aux_loss_coef: float = 1e-2
    # the top-k probabilities divided by their sum (False: the softmax's
    # probabilities themselves weigh the experts, DeepSeek-V2's
    # norm_topk_prob false)
    norm_topk_prob: bool = True
    # every assignment computed, no capacity (one-device serving only)
    dropless: bool = False


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0        # 0 => no q compression (V2-Lite)
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    version: int = 1            # 1 = mamba1 selective scan, 2 = mamba2 SSD
    n_heads: int = 0            # mamba2 heads (d_inner / head_dim)
    head_dim: int = 64
    chunk: int = 256            # SSD chunk length


@dataclass(frozen=True)
class YarnConfig:
    """YaRN rope scaling as DeepSeek-V2 configures it (``rope_scaling`` of
    its config.json, ``type`` yarn): the rope frequencies blended between
    the original and ``factor`` times slower, the softmax scale multiplied
    by ``(0.1 mscale_all_dim ln factor + 1)**2``."""
    factor: float = 1.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper)."""
    n_layers: int = 12
    n_ctx: int = 1500           # audio frames after conv stub


_SUB_CONFIGS = {"moe": MoEConfig, "mla": MLAConfig, "ssm": SSMConfig,
                "encoder": EncoderConfig, "rope_scaling": YarnConfig}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads
    activation: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    max_seq: int = 131_072
    # attention pattern
    window: int = 0             # sliding window size (0 = full)
    local_global_ratio: int = 0 # e.g. 5 => 5 local : 1 global (gemma3)
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # hybrid (zamba2): attention block shared & inserted every k ssm blocks
    hybrid_attn_every: int = 0
    # vlm: number of prefix patch embeddings supplied by the (stub) vision tower
    n_patches: int = 0
    dtype: str = "bfloat16"
    # YaRN rope scaling of the rope tables, its softmax factor in MLA
    # (None: plain rope)
    rope_scaling: Optional[YarnConfig] = None

    def __post_init__(self):
        """Turns a sub-config given as a dict into its dataclass; a key
        the dataclass lacks raises ``TypeError``."""
        for name, cls in _SUB_CONFIGS.items():
            value = getattr(self, name)
            if isinstance(value, dict):
                known = {f.name for f in fields(cls)}
                unknown = sorted(set(value) - known)
                if unknown:
                    raise TypeError(f"{name}: unknown keys {unknown} of "
                                    f"{cls.__name__}")
                object.__setattr__(self, name, cls(**value))

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def has_subquadratic_attention(self) -> bool:
        """True if long-context decode (long_500k) is runnable."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.local_global_ratio > 0 or self.window > 0

    def param_count(self) -> int:
        """Analytical parameter count (embeddings + blocks), the reference's
        formula for every family."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        n = self.vocab * d  # embed
        if not self.tie_embeddings:
            n += self.vocab * d  # lm head
        per_layer = 0
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            per_layer = (d * 2 * d_in        # in_proj (x, z)
                         + d_in * s.d_conv   # depthwise conv
                         + d_in * (s.d_state * 2 + 1)  # B,C,dt proj (approx)
                         + d_in * s.d_state  # A
                         + d_in * d)         # out_proj
            n += L * (per_layer + d)  # + norm
            return n
        # attention params
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        if self.mla is not None:
            m = self.mla
            q = d * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            kv = d * (m.kv_lora_rank + m.qk_rope_dim) \
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            o = self.n_heads * m.v_head_dim * d
        attn = q + kv + o
        # mlp params
        gates = 2 if self.activation in ("swiglu", "geglu") else 1
        if self.moe is not None:
            e = self.moe
            mlp = (e.n_experts + e.n_shared) * (gates + 1) * d * e.d_ff_expert \
                + d * e.n_experts  # router
        else:
            mlp = (gates + 1) * d * self.d_ff
        if self.family == "hybrid":
            # zamba2: mamba blocks everywhere + ONE shared attention+mlp block
            s = self.ssm
            d_in = s.expand * d
            mamba = (d * 2 * d_in + d_in * s.d_conv
                     + d_in * (2 * s.d_state + 1) + s.n_heads
                     + d_in * d)
            n += L * (mamba + d)
            n += attn + mlp + 2 * d  # shared block, counted once
            return n
        n += L * (attn + mlp + 2 * d)
        if self.encoder is not None:
            # encoder layers: self-attn + mlp ; decoder adds cross-attn
            n += self.encoder.n_layers * (attn + mlp + 2 * d)
            n += L * (attn + d)  # cross attention in decoder
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        gates = 2 if self.activation in ("swiglu", "geglu") else 1
        full_mlp = (e.n_experts + e.n_shared) * (gates + 1) * self.d_model * e.d_ff_expert
        act_mlp = (e.top_k + e.n_shared) * (gates + 1) * self.d_model * e.d_ff_expert
        return self.param_count() - self.n_layers * (full_mlp - act_mlp)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode
    # decode shapes: seq_len is the KV-cache length; one new token is produced

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def cell_is_runnable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch x shape) cell runs, and why not if it doesn't."""
    if shape.name == "long_500k" and not model.has_subquadratic_attention:
        return False, "pure full-attention arch: long_500k skipped per assignment"
    return True, ""
