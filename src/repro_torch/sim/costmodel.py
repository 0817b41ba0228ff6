"""Vectorized analytic cost model over continuous hardware parameters.

The event engine prices a program one op-event at a time; on a linear chain
the whole schedule is a prefix sum of per-op (host, transfer, compute,
collective) terms.  This module holds those per-op terms as pure functions
of a **continuous hardware-parameter vector** (``hw.PARAM_FIELDS``:
peak_flops, datapath_scale, hbm/vmem/ici bandwidth, hbm_ports,
host_dispatch_s, host_bw, host_threads and the fabric tiers' rates), so that

  * the engine's chain fast path (``engine._run_chain``) calls the SAME
    functions with scalar parameters; and
  * a whole design-point batch evaluates at once: a (B, 14) parameter
    matrix broadcast against the (m,) per-op arrays gives a (B, 4m)
    interleaved term matrix whose row-wise ``cumsum`` ends are the B
    makespans (:class:`CostModel`).

Exactness contract:

  * **chain programs** (token-by-token decode, macro-op chains, the camera
    ISP): the numpy backend is **bit-identical** to ``engine.run``.
    ``np.cumsum`` performs the same strict left-to-right IEEE additions as
    the event loop's ``itertools.accumulate``.
  * **DAG programs**: the model returns a certified bracket
    ``lower <= exact <= upper``.  ``lower`` is the max of four relaxations
    (critical path with every transfer at its uncontended factor,
    aggregate device work over the worker count, the serial host lane, the
    busiest collective lane); ``upper`` charges every op serially with
    every transfer at the worst contention factor ``max(1, n_workers /
    ports)``.  The exact engine stays the verifier of record
    (``sweep.batched`` / ``sweep.optimize`` re-run their winners through
    ``engine.run``).

Backends: numpy, and ``torch``, which evaluates the same term functions in
float64 torch (on the card unless ``device="cpu"``) through a small
namespace object (:class:`_TorchOps`) and gives ``sweep.optimize``
``torch.func`` gradients.  The torch backend sums each row as one reduction,
so it promises ``allclose``, not bit-equality; it is chain-only (the DAG
critical-path recurrence is a Python loop over ops).

The port's copy of ``repro/sim/costmodel.py``; its jax backend is the
torch one here.  numpy only at import: torch loads when the torch backend
is asked for.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.energy import EnergyModel
from repro_torch.core.interfaces import DMA_LAUNCH_S, FLUSH_PER_BYTE
from repro_torch.sim import backends as _backends
from repro_torch.sim import hw
from repro_torch.sim.hw import PARAM_FIELDS

__all__ = ["CHAIN_INTERFACES", "ChainParams", "ChainTerms", "CostModel",
           "Objective", "OpArrays", "Unsupported", "chain_params_for",
           "chain_terms", "interleave", "op_arrays", "relaxation_err"]

# interfaces the analytic term functions mirror exactly; a custom
# interface registered into engine.INTERFACES falls back to the event loop
CHAIN_INTERFACES = frozenset({"hbm", "ideal", "dma", "acp"})


class Unsupported(ValueError):
    """This (program, config) pair has no analytic model — heterogeneous
    cost signatures, a custom interface/energy model, per-tier fabric
    overrides, a non-roofline cost backend, or a torch request on a DAG.
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
# the continuous parameter point (scalars for the engine, (B,1) columns
# for a batch, 0-d tensors under torch.func)


@dataclasses.dataclass(frozen=True)
class ChainParams:
    """One hardware design point (or a broadcastable batch of them).

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

    @classmethod
    def from_matrix(cls, P, statics: Dict, xp=np) -> "ChainParams":
        """(B, 14) parameter matrix -> (B, 1) columns that broadcast
        against the (m,) op arrays."""
        P = xp.asarray(P)
        cols = {f: P[:, i:i + 1] for i, f in enumerate(PARAM_FIELDS)}
        return cls(**cols, **statics)

    @classmethod
    def from_vector(cls, vec, statics: Dict) -> "ChainParams":
        """A single parameter vector (0-d tensors under torch.func
        welcome)."""
        cols = {f: vec[i] for i, f in enumerate(PARAM_FIELDS)}
        return cls(**cols, **statics)


@dataclasses.dataclass(frozen=True)
class ChainTerms:
    """Per-op cost terms at a parameter point — what the event loop (and
    its chain prefix sum) charges.  All arrays broadcast to the batch."""
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
    parameters this IS the engine's chain fast path math; with (B, 1)
    columns it prices B design points at once; with ``xp=_TorchOps(...)``
    it runs in torch, traceable by ``torch.func``.

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


# ---------------------------------------------------------------------------
# torch as the array module of chain_terms / interleave


class _TorchOps:
    """The array-module calls of :func:`chain_terms` and :func:`interleave`
    in float64 torch on one device.  Operators (``+``, ``/``, ``<``, ``|``
    ...) need no translation; these calls do: torch's ``maximum`` and
    ``where`` want tensors where numpy takes Python scalars (and a
    scalar-only ``where`` would come back float32), ``stack`` names its
    axis ``dim``, and ``asarray`` must pin the dtype and device."""

    def __init__(self, torch, device):
        self.torch = torch
        self.device = device

    def asarray(self, x):
        """A tensor on the device: bool and integer arrays keep their kind,
        everything else (Python floats included) becomes float64."""
        if isinstance(x, self.torch.Tensor):
            return x
        x = np.asarray(x)
        dtype = (self.torch.bool if x.dtype == bool else self.torch.int64
                 if x.dtype.kind == "i" else self.torch.float64)
        return self.torch.as_tensor(x, dtype=dtype, device=self.device)

    def where(self, cond, x, y):
        return self.torch.where(cond, self.asarray(x), self.asarray(y))

    def maximum(self, x, y):
        return self.torch.maximum(self.asarray(x), self.asarray(y))

    def floor_divide(self, x, y):
        return self.torch.floor_divide(self.asarray(x), self.asarray(y))

    def zeros_like(self, x):
        return self.torch.zeros_like(x)

    def stack(self, xs, axis=0):
        return self.torch.stack(xs, dim=axis)

    def reshape(self, x, shape):
        return self.torch.reshape(x, shape)


# ---------------------------------------------------------------------------
# program-side structure cache (arrays + chain flag + DAG order), keyed on
# program identity like sweep's lowering caches


_INFO_MAX = 32
_info_cache: "OrderedDict[int, tuple]" = OrderedDict()


def _program_info(program):
    key = id(program)
    hit = _info_cache.get(key)
    if hit is not None and hit[0] is program:
        _info_cache.move_to_end(key)
        return hit
    ops = program.ops
    arrays = op_arrays(ops)
    names = {op.name: i for i, op in enumerate(ops)}
    deps = tuple(tuple(names[d] for d in op.deps if d in names)
                 for op in ops)
    is_chain = len(names) == len(ops)
    prev = None
    for op in ops:
        if not is_chain:
            break
        if op.affinity is not None:
            is_chain = False
            break
        want = () if prev is None else (prev,)
        if tuple(op.deps) != want:
            is_chain = False
            break
        prev = op.name
    # Kahn topological order for the DAG critical-path recurrence
    n_wait = [len(d) for d in deps]
    consumers: List[List[int]] = [[] for _ in ops]
    for i, d in enumerate(deps):
        for j in d:
            consumers[j].append(i)
    queue = [i for i, w in enumerate(n_wait) if w == 0]
    order: List[int] = []
    for i in queue:
        order.append(i)
        for c in consumers[i]:
            n_wait[c] -= 1
            if n_wait[c] == 0:
                queue.append(c)
    info = (program, arrays, is_chain, deps,
            tuple(order) if len(order) == len(ops) else None)
    if len(_info_cache) >= _INFO_MAX:
        _info_cache.popitem(last=False)
    _info_cache[key] = info
    return info


# ---------------------------------------------------------------------------
# the model


class CostModel:
    """Analytic cost model of one program under one categorical config.

    ``makespans(P)`` prices an (B, 14) ``hw.PARAM_FIELDS`` matrix: exact
    (numpy bit-identical to ``engine.run``; torch allclose) on chains, the
    certified lower bound on DAGs.  ``bounds(P)`` returns the (lower,
    upper) bracket.  ``objective(space, ...)`` builds the z-space
    value/gradient pair ``sweep.optimize`` descends.  Raises
    ``Unsupported`` when the (program, config) pair has no analytic model —
    callers keep the event engine as the fallback/verifier.

    ``backend`` is ``"numpy"``, ``"torch"`` (chains only; float64 on
    ``device``, resolved by ``core.device.resolve_device``: the card unless
    ``device="cpu"``, and an error where there is no card) or ``"auto"``:
    torch on chains, numpy on DAGs.
    """

    def __init__(self, program, base_config=None, *, backend: str = "auto",
                 device=None):
        from repro_torch.sim import engine   # lazy: engine imports us too
        self.program = program
        base = base_config if base_config is not None \
            else engine.EngineConfig()
        self.base = base
        if type(base.energy) is not EnergyModel:
            raise Unsupported("custom EnergyModel subclass: the analytic "
                              "terms mirror the default model only")
        if base.fabric is not None and base.fabric.has_overrides():
            raise Unsupported(
                "fabric carries explicit per-tier rate overrides; the "
                "analytic model prices tiers from the flat PARAM_FIELDS "
                "only")
        topo = base.resolved_topology()
        res = engine._resolve(base, topo)
        if len(res.sig_cfgs) != 1 or len(res.ports_l) != 1:
            raise Unsupported(
                "heterogeneous topology: devices resolve to more than one "
                "cost signature or link; use the event engine")
        eff = res.sig_cfgs[0]
        if eff.interface not in CHAIN_INTERFACES:
            raise Unsupported(
                f"no analytic model for interface {eff.interface!r}")
        if not (_backends.is_roofline(base.cost_backend)
                and _backends.is_roofline(eff.cost_backend)):
            raise Unsupported(
                "non-roofline cost backend: per-op compute is priced by "
                "backend.op_time, outside the analytic chain terms; use "
                "the exact engine (sweep())")
        self._eff = eff
        self._ports = res.ports_l[0]
        self.n_workers = len(topo.devices)
        (_, self.arrays, self.is_chain, self._deps,
         self._order) = _program_info(program)
        em = base.energy
        self._statics = dict(
            interface=eff.interface, overlap=eff.overlap,
            vmem_resident_bytes=eff.vmem_resident_bytes,
            dma_transfer_bytes=eff.dma_transfer_bytes,
            pj_hbm=em.pj_per_byte_hbm, pj_vmem=em.pj_per_byte_vmem,
            pj_host=em.pj_per_byte_host)
        p0 = dict(zip(PARAM_FIELDS, hw.params_from_config(base)))
        p0.update(peak_flops=eff.peak_flops,
                  datapath_scale=eff.datapath_scale, hbm_bw=eff.hbm_bw,
                  vmem_bw=eff.vmem_bw, hbm_ports=float(self._ports))
        self.params0 = np.array([p0[f] for f in PARAM_FIELDS],
                                dtype=np.float64)
        if backend == "auto":
            backend = "torch" if self.is_chain else "numpy"
        elif backend == "torch":
            if not self.is_chain:
                raise Unsupported("torch backend is chain-only (the DAG "
                                  "critical-path recurrence is a Python "
                                  "loop over ops)")
        elif backend != "numpy":
            raise ValueError(f"unknown backend {backend!r}; "
                             "one of numpy|torch|auto")
        self.backend = backend
        self.device = None
        if backend == "torch":
            from repro_torch.core.device import resolve_device
            self.device = resolve_device("cuda" if device is None
                                         else device)
        self._torch = None

    # -- evaluation ---------------------------------------------------------

    def _as_matrix(self, P) -> np.ndarray:
        P = np.asarray(P, dtype=np.float64)
        if P.ndim == 1:
            P = P[None, :]
        if P.ndim != 2 or P.shape[1] != len(PARAM_FIELDS):
            raise ValueError(
                f"expected an (B, {len(PARAM_FIELDS)}) matrix over "
                f"hw.PARAM_FIELDS, got shape {P.shape}")
        return P

    def _chain(self, P: np.ndarray) -> np.ndarray:
        if self.backend == "torch":
            return self._chain_torch(P)
        return self._chain_numpy(P)

    def makespans(self, P) -> np.ndarray:
        """(B,) makespans: exact on chains (numpy backend bit-identical
        to ``engine.run``; torch allclose), the lower bound on DAGs."""
        P = self._as_matrix(P)
        if self.is_chain:
            return self._chain(P)
        return self._dag_bounds(P)[0]

    def bounds(self, P, n_workers=None) -> Tuple[np.ndarray, np.ndarray]:
        """The certified (lower, upper) makespan bracket; on chains both
        sides are the exact value."""
        P = self._as_matrix(P)
        if self.is_chain:
            ms = self._chain(P)
            return ms, ms.copy()
        return self._dag_bounds(P, n_workers=n_workers)

    def makespan(self) -> float:
        """The model's value at the base config's own parameter point
        (exact on chains, lower bound on DAGs) — numpy path, so chain
        values are bit-identical to ``engine.run(program, base)``."""
        if self.is_chain:
            return float(self._chain_numpy(self.params0[None, :])[0])
        return float(self._dag_bounds(self.params0[None, :])[0][0])

    def _chain_numpy(self, P: np.ndarray) -> np.ndarray:
        m = self.arrays.m
        B = len(P)
        if m == 0:
            return np.zeros(B, dtype=np.float64)
        out = np.empty(B, dtype=np.float64)
        # bound the (chunk, 4m) scratch to ~16 MiB
        chunk = max(1, int(2_000_000 // max(1, 4 * m)))
        for s in range(0, B, chunk):
            p = ChainParams.from_matrix(P[s:s + chunk], self._statics)
            flat = interleave(chain_terms(self.arrays, p))
            # row-wise cumsum adds strictly left-to-right: the last
            # column IS the event loop's accumulate() total, bit-for-bit
            out[s:s + chunk] = np.cumsum(flat, axis=-1)[:, -1]
        return out

    def _dag_bounds(self, P: np.ndarray, n_workers=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        if self._order is None:
            raise Unsupported("dependency cycle in program")
        m = self.arrays.m
        B = len(P)
        if m == 0:
            z = np.zeros(B, dtype=np.float64)
            return z, z.copy()
        p = ChainParams.from_matrix(P, self._statics)
        t = chain_terms(self.arrays, p)
        hcz = np.where(t.has_h, t.hc, 0.0)
        v_min = hcz + t.xfer + t.comp + t.cdur          # (B, m)
        # lower bound: max of four relaxations, each of which the event
        # loop provably cannot beat (done[op] >= done[dep] + its charges;
        # per-device, host-lane and ICI-lane work all fit inside the span)
        done = np.zeros((B, m), dtype=np.float64)
        for i in self._order:
            d = self._deps[i]
            if d:
                ready = done[:, d[0]]
                for j in d[1:]:
                    ready = np.maximum(ready, done[:, j])
                done[:, i] = ready + v_min[:, i]
            else:
                done[:, i] = v_min[:, i]
        crit = done.max(axis=-1)
        nw = (np.full(B, float(self.n_workers))
              if n_workers is None
              else np.asarray(n_workers, dtype=np.float64))
        work = np.sum(t.xfer + t.comp, axis=-1) / nw
        # collective relaxation: each LANE is serial, but distinct fabric
        # lanes run in parallel — the busiest lane bounds the span (the
        # single-lane case is the serial-ICI sum, bit for bit)
        a = self.arrays
        if a.n_lanes > 1:
            coll_lane = np.zeros(B, dtype=np.float64)
            for l in range(a.n_lanes):
                mask = a.lane_code == l
                if mask.any():
                    coll_lane = np.maximum(
                        coll_lane, np.sum(t.cdur[:, mask], axis=-1))
        else:
            coll_lane = np.sum(t.cdur, axis=-1)
        lower = np.maximum(
            np.maximum(crit, work),
            np.maximum(np.sum(hcz, axis=-1), coll_lane))
        # upper bound: serial sum with every transfer at the worst-case
        # contention factor (live transfers never exceed the devices on
        # the link, so factor <= max(1, n_workers/ports))
        ports = np.asarray(p.hbm_ports)[:, 0]
        pos = ports > 0.0
        fmax = np.where(
            pos, np.maximum(1.0, np.minimum(nw, float(m))
                            / np.where(pos, ports, 1.0)), 1.0)
        upper = np.sum(hcz + t.expo * fmax[:, None] + t.comp + t.cdur,
                       axis=-1)
        return lower, upper

    # -- torch backend ------------------------------------------------------

    def _torch_state(self):
        """(torch, the namespace, the op arrays as tensors on the device):
        the ``OpArrays`` columns cross to the device once."""
        if self._torch is None:
            import torch
            ops = _TorchOps(torch, self.device)
            a = self.arrays
            ta = OpArrays(m=a.m, flops=ops.asarray(a.flops),
                          dot=ops.asarray(a.dot), nb=ops.asarray(a.nb),
                          coll=ops.asarray(a.coll),
                          has_dur=ops.asarray(a.has_dur),
                          dur=ops.asarray(a.dur),
                          has_tov=ops.asarray(a.has_tov),
                          tov=ops.asarray(a.tov),
                          tcode=ops.asarray(a.tcode),
                          hops=ops.asarray(a.hops),
                          lane_code=a.lane_code, n_lanes=a.n_lanes,
                          any_tier=a.any_tier)
            self._torch = (torch, ops, ta)
        return self._torch

    def _chain_torch(self, P: np.ndarray) -> np.ndarray:
        m = self.arrays.m
        B = len(P)
        if m == 0:
            return np.zeros(B, dtype=np.float64)
        torch, ops, ta = self._torch_state()
        out = []
        # bound the (chunk, 4m) float64 rows to ~128 MiB a chunk
        chunk = max(1, int(16_000_000 // max(1, 4 * m)))
        with torch.no_grad():
            Pt = ops.asarray(P)
            for s in range(0, B, chunk):
                p = ChainParams.from_matrix(Pt[s:s + chunk], self._statics,
                                            xp=ops)
                out.append(interleave(chain_terms(ta, p, xp=ops),
                                      xp=ops).sum(-1))
            return torch.cat(out).cpu().numpy()

    def _torch_chain_one(self) -> Callable:
        """One design point's makespan as a function of its parameter
        vector: what ``torch.func.grad`` differentiates."""
        torch, ops, ta = self._torch_state()
        statics = self._statics

        def one(pvec):
            p = ChainParams.from_vector(pvec, statics)
            return interleave(chain_terms(ta, p, xp=ops), xp=ops).sum()
        return one

    # -- design-space objective (z-space in [0, 1]^d) -----------------------

    def config_for(self, params) -> "object":
        """The exact-engine config at a parameter point (only the given
        fields are replaced on the base config)."""
        return hw.apply_params(self.base, params)

    def objective(self, space: Dict[str, Tuple[float, float]], *,
                  target_s: Optional[float] = None,
                  cost: Optional[Callable] = None) -> "Objective":
        """Build the normalized design-space objective.

        ``space`` maps ``hw.PARAM_FIELDS`` names to (lo, hi) ranges; a
        point is a z-vector in [0, 1]^d mapped geometrically onto each
        range (linearly when lo <= 0).  Without ``target_s`` the
        objective is ``log(makespan)`` (scale-free descent direction);
        with it, ``cost + 100 * relu(makespan/target - 1)^2`` where
        ``cost`` defaults to ``mean(z)`` (bigger hardware = costlier) —
        "the cheapest design meeting the latency target".  Gradients are
        analytic (``torch.func.vmap(torch.func.grad(...))``) on the torch
        backend, batched central differences on numpy; a custom ``cost``
        callable (taking the (B, 14) matrix) always uses finite
        differences."""
        names = list(space)
        for k in names:
            if k not in PARAM_FIELDS:
                raise ValueError(f"unknown space field {k!r}; "
                                 f"one of {PARAM_FIELDS}")
        dims = [PARAM_FIELDS.index(k) for k in names]
        lo = np.array([float(space[k][0]) for k in names])
        hi = np.array([float(space[k][1]) for k in names])
        if np.any(hi < lo):
            raise ValueError("space ranges need hi >= lo")
        geo = lo > 0.0
        ratio = np.where(geo, hi / np.where(geo, lo, 1.0), 1.0)

        def to_values(Z, xp=np):
            return xp.where(geo, lo * ratio ** Z, lo + (hi - lo) * Z)

        def to_params(Z) -> np.ndarray:
            Z = np.atleast_2d(np.asarray(Z, dtype=np.float64))
            P = np.tile(self.params0, (len(Z), 1))
            P[:, dims] = to_values(Z)
            return P

        def value(Z) -> np.ndarray:
            Z = np.atleast_2d(np.asarray(Z, dtype=np.float64))
            ms = self.makespans(to_params(Z))
            if target_s is None:
                return np.log(np.maximum(ms, 1e-300))
            c = cost(to_params(Z)) if cost is not None else Z.mean(axis=1)
            return c + 100.0 * np.maximum(ms / target_s - 1.0, 0.0) ** 2

        if self.backend == "torch" and self.is_chain and cost is None:
            torch, ops, _ = self._torch_state()
            one = self._torch_chain_one()
            p0 = ops.asarray(self.params0)
            tlo, tratio, thi = (ops.asarray(lo), ops.asarray(ratio),
                                ops.asarray(hi))
            tgeo = ops.asarray(geo)
            slot = {di: k for k, di in enumerate(dims)}

            def obj_one(zvec):
                vals = torch.where(tgeo, tlo * tratio ** zvec,
                                   tlo + (thi - tlo) * zvec)
                ms = one([vals[slot[i]] if i in slot else p0[i]
                          for i in range(len(PARAM_FIELDS))])
                if target_s is None:
                    return torch.log(torch.clamp_min(ms, 1e-300))
                return (zvec.mean()
                        + 100.0 * torch.clamp_min(ms / target_s - 1.0,
                                                  0.0) ** 2)
            tgrad = torch.func.vmap(torch.func.grad(obj_one))

            def grad(Z) -> np.ndarray:
                Z = np.atleast_2d(np.asarray(Z, dtype=np.float64))
                return tgrad(ops.asarray(Z)).detach().cpu().numpy()
            backend = "torch"
        else:
            def grad(Z) -> np.ndarray:
                """Batched central differences: one vectorized value()
                call prices the whole 2*d*S stencil."""
                Z = np.atleast_2d(np.asarray(Z, dtype=np.float64))
                S, d = Z.shape
                h = 1e-4
                E = np.eye(d) * h
                stack = np.concatenate([
                    (Z[None, :, :] + E[:, None, :]).reshape(-1, d),
                    (Z[None, :, :] - E[:, None, :]).reshape(-1, d)])
                v = value(np.clip(stack, 0.0, 1.0))
                vp = v[:d * S].reshape(d, S)
                vm = v[d * S:].reshape(d, S)
                return ((vp - vm) / (2.0 * h)).T
            backend = "numpy"
        return Objective(names=tuple(names), dims=tuple(dims),
                         lo=lo, hi=hi, value=value, grad=grad,
                         to_params=to_params, backend=backend,
                         target_s=target_s)


@dataclasses.dataclass(frozen=True)
class Objective:
    """The z-space objective ``sweep.optimize`` descends."""
    names: Tuple[str, ...]
    dims: Tuple[int, ...]
    lo: np.ndarray
    hi: np.ndarray
    value: Callable         # (S, d) -> (S,)
    grad: Callable          # (S, d) -> (S, d)
    to_params: Callable     # (S, d) -> (S, 14)
    backend: str
    target_s: Optional[float]


# ---------------------------------------------------------------------------
# model-fidelity probe for sweep.as_records


def relaxation_err(result) -> Optional[float]:
    """Relative error of the analytic model against an exact
    ``EngineResult``: 0.0 on chains (the model IS the fast path),
    ``(lower - exact) / exact`` (<= 0) on DAGs, ``None`` when the
    (program, config) pair has no analytic model."""
    try:
        model = CostModel(result.program, result.config, backend="numpy")
    except Unsupported:
        return None
    analytic = model.makespan()
    exact = result.makespan
    if not np.isfinite(analytic):
        return None
    if exact == 0.0:
        return 0.0 if analytic == 0.0 else None
    return (analytic - exact) / exact
