"""Full-stack simulator: the port's copy of the JAX package's
``repro.core.simulator``, a stable API over the unified engine
(``repro_torch.sim``).

``roofline()`` / ``breakdown()`` lower a cost dict in ``core.hlo``'s schema
(``analyze_hlo`` of XLA text, or ``analyze_step`` of a traced torch step) to
a ``repro_torch.sim`` Program and read the terms off one engine run.

The hardware is the engine's config, the one keyword the reference lacks:
``config`` (an ``EngineConfig``) defaults to one H100 at its dense bf16 peak
(``default_config``), what ``launch/train.py --dry-run`` and
``apps.serving`` price on, since the served and trained models run bf16.
The engine's own fields that the reference sets (one worker, the ``hbm``
interface, the host floor, the chip count) are set on it the same way, so
at the reference's TPU v5e constants passed in ``config`` every result is
the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.config import ModelConfig, ShapeConfig
from repro_torch.core.energy import DEFAULT_ENERGY, EnergyModel
from repro_torch.sim import hw
from repro_torch.sim.hw import (HBM_BW, HOST_OVERHEAD_S, ICI_BW,  # noqa: F401
                                PEAK_FLOPS, PEAK_FLOPS_BF16)
from repro_torch.sim.report import Breakdown, Roofline  # noqa: F401


def default_config():
    """One H100 at its dense bf16 peak."""
    from repro_torch.sim.engine import EngineConfig
    return EngineConfig(peak_flops=hw.PEAK_FLOPS_BF16)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); decode counts the
    one generated token; prefill/train count the full sequence.  Inference
    shapes use the 2·N·D forward-only form."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one new token per sequence; attention reads the full KV cache —
    # add the 2·(kv re-read compute) term: 2 * 2 * L * d_kv * S per token
    tokens = shape.global_batch
    base = 2.0 * n * tokens
    if cfg.n_kv_heads and cfg.family not in ("ssm",):
        kv_dim = cfg.n_kv_heads * cfg.resolved_head_dim
        n_attn_layers = (cfg.n_layers // cfg.hybrid_attn_every
                         if cfg.family == "hybrid" else cfg.n_layers)
        base += 4.0 * n_attn_layers * kv_dim * shape.seq_len * tokens
    return base


def _engine_run(hlo: Dict, *, host_s: float, mf: float = 0.0,
                n_chips: int = 1, config=None):
    from repro_torch.sim import engine, ir
    prog = ir.from_hlo(hlo)
    cfg = dataclasses.replace(config or default_config(), n_workers=1,
                              interface="hbm", host_floor_s=host_s,
                              n_chips=n_chips)
    return engine.run(prog, cfg, model_flops=mf)


def roofline(hlo: Dict, cfg: Optional[ModelConfig],
             shape: Optional[ShapeConfig], n_chips: int, *,
             host_s: float = HOST_OVERHEAD_S, config=None) -> Roofline:
    """hlo: a cost dict of ONE device's (rank's) step, ``core.hlo``'s
    schema."""
    mf = model_flops(cfg, shape) if cfg is not None else 0.0
    return _engine_run(hlo, host_s=host_s, mf=mf, n_chips=n_chips,
                       config=config).roofline


def breakdown(hlo: Dict, *, host_prep_s: float = 0.0,
              serialize_transfers: bool = True, config=None) -> Breakdown:
    """Decompose the analyzed step into SMAUG's Fig-1 phases.

    accelerator = compute time of the step's flops; transfer = HBM traffic
    beyond what the matrix units hide behind the dots; collective = link
    time; host = modelled framework time.  All four are aggregations of one
    engine run's timeline (``serialize_transfers`` is kept for API
    compatibility — the engine's "hbm" interface is the serialized
    baseline)."""
    res = _engine_run(hlo, host_s=host_prep_s + HOST_OVERHEAD_S,
                      config=config)
    return res.breakdown


def energy(hlo: Dict, seconds: float, n_chips: int = 1,
           em: EnergyModel = DEFAULT_ENERGY) -> Dict[str, float]:
    """The energy model's terms (``core.energy``: the modeled SoC's
    per-op energies, not the card's)."""
    e_comp = em.compute(hlo["flops"])
    e_hbm = em.hbm(hlo["bytes"])
    e_ici = em.ici(hlo["collective_bytes"])
    e_static = em.static(seconds, 1)
    return {"compute_j": e_comp, "hbm_j": e_hbm, "ici_j": e_ici,
            "static_j": e_static,
            "total_j": e_comp + e_hbm + e_ici + e_static,
            "total_j_all_chips": (e_comp + e_hbm + e_ici + e_static) * n_chips}
