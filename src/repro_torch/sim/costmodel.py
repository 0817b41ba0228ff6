"""The per-op cost terms of the engine, as functions of the hardware point.

The event engine prices a program one op-event at a time; on a linear chain
the whole schedule is a prefix sum of per-op (host, transfer, compute,
collective) terms.  This module holds those per-op terms as pure functions
of a **continuous hardware-parameter vector** (``hw.PARAM_FIELDS``:
peak_flops, datapath_scale, hbm/vmem/ici bandwidth, hbm_ports,
host_dispatch_s, host_bw, host_threads and the fabric tiers' rates), and the
engine's chain fast path (``engine._run_chain``) and its hoisted per-op
arrays call them with scalar parameters.  ``np.cumsum`` over the
interleaved terms performs the same strict left-to-right IEEE additions as
the event loop's ``itertools.accumulate``, so the fast path is
bit-identical to the event loop.

The port's copy of the part of ``repro/sim/costmodel.py`` the engine calls;
numpy only.  The reference's batched ``CostModel`` (and its autodiff backend)
waits for the port's sweep layer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from repro_torch.core.interfaces import DMA_LAUNCH_S, FLUSH_PER_BYTE
from repro_torch.sim import backends as _backends
from repro_torch.sim import hw

__all__ = ["CHAIN_INTERFACES", "ChainParams", "ChainTerms", "OpArrays",
           "Unsupported", "chain_params_for", "chain_terms", "interleave",
           "op_arrays"]

# interfaces the analytic term functions mirror exactly; a custom
# interface registered into engine.INTERFACES falls back to the event loop
CHAIN_INTERFACES = frozenset({"hbm", "ideal", "dma", "acp"})


class Unsupported(ValueError):
    """This (program, config) pair has no analytic model — a custom
    interface, per-tier fabric overrides or a non-roofline cost backend.
    The event engine still simulates it."""


# ---------------------------------------------------------------------------
# per-op arrays: the program side of the cost terms (parameter-free)


@dataclasses.dataclass(frozen=True)
class OpArrays:
    """Columnar view of a program's per-op cost inputs (float64)."""
    m: int
    flops: np.ndarray
    dot: np.ndarray
    nb: np.ndarray          # bytes_in + bytes_out
    coll: np.ndarray
    has_dur: np.ndarray
    dur: np.ndarray
    has_tov: np.ndarray     # explicit transfer_s override
    tov: np.ndarray
    # fabric collectives: per-op tier code (hw.TIER_NAMES index, -1 = not
    # a fabric hop), latency-hop multiplier, and a factorized lane id for
    # the per-lane DAG relaxation.  ``any_tier`` gates the tier math so
    # legacy programs run the exact pre-fabric operations.
    tcode: np.ndarray = None
    hops: np.ndarray = None
    lane_code: np.ndarray = None
    n_lanes: int = 1
    any_tier: bool = False


def op_arrays(ops: Sequence) -> OpArrays:
    """Extract the per-op cost columns of a sequence of ``CostedOp``s —
    exactly the arrays the chain fast path hoists."""
    tcodes = [(-1 if op.tier is None else hw.TIER_NAMES.index(op.tier))
              for op in ops]
    lanes: Dict[str, int] = {}
    lane_code = []
    for op in ops:
        lane_code.append(lanes.setdefault(op.lane, len(lanes)))
    return OpArrays(
        m=len(ops),
        flops=np.array([op.flops for op in ops], dtype=np.float64),
        dot=np.array([op.dot_flops for op in ops], dtype=np.float64),
        nb=np.array([op.bytes_in + op.bytes_out for op in ops],
                    dtype=np.float64),
        coll=np.array([op.collective_bytes for op in ops],
                      dtype=np.float64),
        has_dur=np.array([op.duration_s is not None for op in ops],
                         dtype=bool),
        dur=np.array([op.duration_s or 0.0 for op in ops],
                     dtype=np.float64),
        has_tov=np.array([op.transfer_s is not None for op in ops],
                         dtype=bool),
        tov=np.array([op.transfer_s or 0.0 for op in ops],
                     dtype=np.float64),
        tcode=np.array(tcodes, dtype=np.int64),
        hops=np.array([op.hops for op in ops], dtype=np.float64),
        lane_code=np.array(lane_code, dtype=np.int64),
        n_lanes=max(len(lanes), 1),
        any_tier=any(c >= 0 for c in tcodes))


# ---------------------------------------------------------------------------
# the continuous parameter point (scalars for the engine)


@dataclasses.dataclass(frozen=True)
class ChainParams:
    """One hardware design point.

    The ``hw.PARAM_FIELDS`` are continuous; the rest are the
    categorical/static knobs that stay fixed within a batch."""
    peak_flops: object
    datapath_scale: object
    hbm_bw: object
    vmem_bw: object
    ici_bw: object
    hbm_ports: object
    host_dispatch_s: object
    host_bw: object
    host_threads: object
    # fabric tier rates (continuous PARAM_FIELDS like the rest; the tier
    # named "ici" shares ``ici_bw`` with the legacy collective lane)
    ici_lat_s: object
    node_bw: object
    node_lat_s: object
    inter_bw: object
    inter_lat_s: object
    # statics
    interface: str
    overlap: bool
    vmem_resident_bytes: float
    dma_transfer_bytes: float
    pj_hbm: float
    pj_vmem: float
    pj_host: float

    @classmethod
    def from_engine(cls, config, eff, ports) -> "ChainParams":
        """The engine chain fast path's exact scalar parameters: device
        terms at the resolved device config ``eff``, host/ICI terms at
        the flat ``config`` — the same split ``_run_chain`` used."""
        em = config.energy
        return cls(peak_flops=eff.peak_flops,
                   datapath_scale=eff.datapath_scale,
                   hbm_bw=eff.hbm_bw, vmem_bw=eff.vmem_bw,
                   ici_bw=config.ici_bw, hbm_ports=ports,
                   host_dispatch_s=config.host_dispatch_s,
                   host_bw=config.host_bw,
                   host_threads=config.host_threads,
                   ici_lat_s=config.ici_lat_s,
                   node_bw=config.node_bw,
                   node_lat_s=config.node_lat_s,
                   inter_bw=config.inter_bw,
                   inter_lat_s=config.inter_lat_s,
                   interface=eff.interface, overlap=eff.overlap,
                   vmem_resident_bytes=eff.vmem_resident_bytes,
                   dma_transfer_bytes=eff.dma_transfer_bytes,
                   pj_hbm=em.pj_per_byte_hbm, pj_vmem=em.pj_per_byte_vmem,
                   pj_host=em.pj_per_byte_host)


@dataclasses.dataclass(frozen=True)
class ChainTerms:
    """Per-op cost terms at a parameter point — what the event loop (and
    its chain prefix sum) charges."""
    comp: object
    full: object            # full interface seconds (pre-overlap)
    expo: object            # exposed seconds, pre-contention
    xfer: object            # exposed * chain contention factor
    xe: object              # transfer energy (J)
    hc: object              # host dispatch + tiling term
    cdur: object            # collective seconds on the ICI lane
    factor: object          # chain contention factor max(1, 1/ports)
    has_h: object
    has_x: object
    has_c: object


def chain_terms(a: OpArrays, p: ChainParams, xp=np,
                comp=None) -> ChainTerms:
    """The hoisted per-op terms of ``engine._run_chain`` as a pure
    function of (op arrays, parameter point) — formulas, operation order
    and IEEE semantics identical to the scalar interface models in
    ``core.interfaces`` / ``core.energy``.  With ``xp=np`` and scalar
    parameters this IS the engine's chain fast path math; ``xp`` is kept
    so that an array module with numpy's API can evaluate the same terms.

    ``comp`` overrides the roofline compute column with externally priced
    per-op seconds (``engine._run_chain`` passes the cost backend's
    ``op_time`` values, keeping the chain fast path bit-identical to the
    event loop under non-roofline backends)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        if comp is None:
            comp = xp.where(a.has_dur, a.dur, a.flops / p.peak_flops)
        else:
            comp = xp.asarray(comp)

        nb = a.nb
        iface = p.interface
        if iface == "hbm":
            t_if = nb / p.hbm_bw
            e_if = (nb * p.pj_hbm) * 1e-12
        elif iface == "ideal":
            t_if = xp.zeros_like(nb)
            e_if = xp.zeros_like(nb)
        elif iface == "dma":
            n_tr = xp.maximum(1.0,
                              xp.floor_divide(nb, p.dma_transfer_bytes))
            t_if = (2 * nb / p.hbm_bw + n_tr * DMA_LAUNCH_S
                    + nb * FLUSH_PER_BYTE)
            e_if = ((2 * nb) * p.pj_hbm) * 1e-12 \
                + ((nb * 0.05) * p.pj_host) * 1e-12
        elif iface == "acp":
            res_frac = xp.where(nb < p.vmem_resident_bytes, 1.0, 0.5)
            spill = nb * (1.0 - res_frac)
            t_if = (nb * res_frac) / p.vmem_bw \
                + 2 * spill / p.hbm_bw
            e_if = ((2 * nb * res_frac) * p.pj_vmem) * 1e-12 \
                + ((2 * spill) * p.pj_hbm) * 1e-12
        else:
            raise Unsupported(f"no analytic model for interface {iface!r}")
        t_if = t_if / p.datapath_scale
        if p.overlap:
            expo_if = xp.maximum(t_if - a.dot / p.peak_flops, 0.0)
        else:
            expo_if = t_if

        zero_b = nb == 0.0
        full = xp.where(a.has_tov, a.tov, xp.where(zero_b, 0.0, t_if))
        expo = xp.where(a.has_tov, a.tov, xp.where(zero_b, 0.0, expo_if))
        xe = xp.where(a.has_tov, ((a.tov * p.hbm_bw) * p.pj_hbm) * 1e-12,
                      xp.where(zero_b, 0.0, e_if))

        # chain transfers never overlap -> every window sees live == 1
        ports = p.hbm_ports
        pos = ports > 0.0
        factor = xp.where(pos, xp.maximum(1.0, 1.0 / xp.where(pos, ports,
                                                              1.0)), 1.0)
        has_x = expo > 0.0
        xfer = xp.where(has_x, expo * factor, 0.0)

        # the engine branches on the scalar's truthiness (any nonzero
        # host_bw charges the tiling term), so mirror != 0, not > 0
        hb = p.host_bw
        nz = hb != 0.0
        hc = xp.where(nz,
                      p.host_dispatch_s + (nb / xp.where(nz, hb, 1.0))
                      / p.host_threads,
                      p.host_dispatch_s + xp.zeros_like(nb))
        has_h = hc > 0.0
        has_c = a.coll > 0.0
        cdur = xp.where(has_c, a.coll / p.ici_bw, 0.0)
        if a.any_tier:
            # fabric hops: lane-only ops priced hops*lat + bytes/bw at
            # their tier's rates; no host/compute charge.  Gated so
            # tier-free programs run the exact pre-fabric operations.
            is_t = a.tcode >= 0
            t0 = a.tcode == 0
            t1 = a.tcode == 1
            lat = xp.where(t0, p.ici_lat_s,
                           xp.where(t1, p.node_lat_s, p.inter_lat_s))
            bw = xp.where(t0, p.ici_bw,
                          xp.where(t1, p.node_bw, p.inter_bw))
            cdur = xp.where(is_t, a.hops * lat + a.coll / bw, cdur)
            has_c = is_t | has_c
            comp = xp.where(is_t, 0.0, comp)
            hc = xp.where(is_t, 0.0, hc)
            has_h = hc > 0.0
    return ChainTerms(comp=comp, full=full, expo=expo, xfer=xfer, xe=xe,
                      hc=hc, cdur=cdur, factor=factor, has_h=has_h,
                      has_x=has_x, has_c=has_c)


def chain_params_for(config, device_class: str = "accel") -> ChainParams:
    """The scalar :class:`ChainParams` point at which
    ``engine.chain_op_costs`` prices ops of ``device_class`` under
    ``config`` — device terms from the class's resolved reference device,
    host/ICI terms from the flat config.  Raises :class:`Unsupported` for
    interfaces outside :data:`CHAIN_INTERFACES` (custom interfaces keep
    going through the event-loop models)."""
    from repro_torch.sim import engine as _engine
    fab = getattr(config, "fabric", None)
    if fab is not None and fab.has_overrides():
        raise Unsupported(
            "fabric carries explicit per-tier rate overrides; the analytic "
            "model prices tiers from the flat PARAM_FIELDS only")
    eff, ports = _engine._class_params(config, device_class)
    if eff.interface not in CHAIN_INTERFACES:
        raise Unsupported(f"interface {eff.interface!r} has no analytic "
                          "chain model")
    if not _backends.is_roofline(eff.cost_backend):
        raise Unsupported(
            "non-roofline cost backend: per-op compute has no analytic "
            "chain model; price through the exact engine")
    return ChainParams.from_engine(config, eff, ports)


def interleave(t: ChainTerms, xp=np):
    """The (..., 4m) interleaved (host, transfer, compute, collective)
    duration rows whose running sum is the chain schedule — entry order
    identical to the event loop's charge order."""
    parts = xp.stack([xp.where(t.has_h, t.hc, 0.0), t.xfer, t.comp,
                      t.cdur], axis=-1)
    return xp.reshape(parts, parts.shape[:-2] + (4 * parts.shape[-2],))
