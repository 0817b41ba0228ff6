"""Process-global performance flags, the port's copy of the JAX package's
``repro.dist.context``.

A launcher installs a ``PerfFlags`` set; model code reads it through
``perf_flags()``, so the same forward functions serve the baseline and
every ablation without threading flags through call signatures.  The
default is the baseline.  The reference's mesh accessors are not ported
(the port runs on one device), so ``seq_sharded_residual`` and
``bf16_tp_collectives``, which act only on a mesh, have no effect here, as
in the reference without one.
"""
from __future__ import annotations

from dataclasses import dataclass, fields


@dataclass(frozen=True)
class PerfFlags:
    """Beyond-paper optimization switches (all default to baseline).

    attn_remat_chunk      checkpoint the online-softmax body per KV chunk
    windowed_attention    static sliding-window paths for local:global archs
    seq_sharded_residual  Megatron-SP residual stream (acts only on a mesh)
    bf16_tp_collectives   bf16 TP collectives (acts only on a mesh)
    ssm_impl              'scan' (recurrent) | 'chunked' (SSD-style blocks)
    moe_dispatch          'gather' (index dispatch) | 'einsum' (one-hot)
    """
    attn_remat_chunk: bool = False
    windowed_attention: bool = False
    seq_sharded_residual: bool = False
    bf16_tp_collectives: bool = False
    ssm_impl: str = "scan"
    moe_dispatch: str = "gather"

    def __post_init__(self):
        # CLI override strings ("ssm_impl=chunked", bare flags -> True) come
        # through as str; normalize bool-typed fields.
        for f in fields(self):
            v = getattr(self, f.name)
            if f.type == "bool" and isinstance(v, str):
                object.__setattr__(
                    self, f.name, v.lower() in ("1", "true", "yes", "on"))


_STATE = {"flags": PerfFlags()}


def set_perf_flags(flags: PerfFlags) -> None:
    _STATE["flags"] = flags


def perf_flags() -> PerfFlags:
    return _STATE["flags"]
