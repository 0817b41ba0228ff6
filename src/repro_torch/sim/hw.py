"""Hardware model of one NVIDIA H100 SXM (80 GB), the port's card, and the
SoC topology layer.

The constants are the port's copy of ``repro/sim/hw.py``'s, with the H100's
values in place of the TPU v5e's; each names its source.  Dense rates,
without sparsity, at the card's full 700 W power limit; a card set below it
runs slower under load.  Constants that describe SMAUG's modeled SoC rather
than the card (the DMA staging costs in ``core/interfaces.py``, the
``EnergyModel`` defaults, the camera frontend's peaks, the systolic PE
array) stay the JAX package's model and say so where they are defined.

On top of the constants sits the **topology model**: a ``Device`` is one
execution resource on the SoC (a CPU core cluster, an accelerator, a
DSP), a ``Link`` is a shared data-movement resource (the HBM port pool,
an ACP/DMA path), and an ``SoCTopology`` composes them.  SMAUG's case
studies vary exactly this object — how many accelerators share how many
memory ports, and which device runs the camera frontend — so the engine
(``repro_torch.sim.engine``) takes an ``EngineConfig.topology`` and
schedules every ``CostedOp`` onto the device matching its
``device_class``, charging its traffic to that device's link.

Inheritance convention: every ``Device``/``Link`` field that is ``None``
falls back to the corresponding flat ``EngineConfig`` field, so the
*homogeneous expansion* of a flat config (``n_workers`` identical
accelerators on one shared link) is ``SoCTopology.homogeneous(n)`` — and
is bit-identical to the flat config by construction.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

# the calibration loop measures in float32 (kernels/calibrate.py BYTES), so
# its roofline peak is float32 on the CUDA cores, not the tensor cores
PEAK_FLOPS = 67e12           # float32, CUDA cores (NVIDIA H100 data sheet)
PEAK_FLOPS_BF16 = 989e12     # bf16, tensor cores, dense (H100 data sheet)
PEAK_FLOPS_TF32 = 494.7e12   # TF32, tensor cores, dense (H100 data sheet);
                             # a float32-accurate product takes 3 passes
HBM_BW = 3.35e12             # bytes/s, HBM3 (NVIDIA H100 data sheet)
N_SMS = 132                  # streaming multiprocessors (Hopper white paper)
SM_CLOCK_HZ = 1.98e9         # boost clock (NVIDIA H100 data sheet)
SFU_PER_CLOCK = 16           # exponentials per clock per SM (NVIDIA's
                             # arithmetic throughput table, sm_90)
EXP_RATE = N_SMS * SFU_PER_CLOCK * SM_CLOCK_HZ   # exponentials/s
SMEM_BYTES_PER_CLOCK = 128   # shared memory per SM per clock (Hopper white
                             # paper: 32 banks of 4 bytes)
# on-chip operand bandwidth: shared memory over all SMs, 33.4e12 B/s
VMEM_BW = N_SMS * SMEM_BYTES_PER_CLOCK * SM_CLOCK_HZ
ICI_BW = 900e9               # bytes/s, NVLink 4 in total (18 links; NVIDIA
                             # H100 data sheet)
# per-call host time of a kernel wrapper (argument checks, allocation, the
# ctypes call): the float32 matmul's 42.0 us a call, chip_smoke.py phase 8
# (H100 80GB HBM3, 700.00 W)
HOST_OVERHEAD_S = 42.0e-6

# -- fabric tiers (cluster-scale interconnect hierarchy) --------------------
# Per-hop latency + bandwidth for the three canonical tiers: GPUs on one
# NVLink switch (``ici``), the node's NVLink domain (``node``) and
# InfiniBand between nodes (``inter``).  The latencies are estimates of a
# small message's hop, not measured by this repo (it runs on one card): a
# small GPU-to-GPU write over NVLink takes some 2 us, the order of what
# CUDA's p2pBandwidthLatencyTest sample reports on NVSwitch systems.
ICI_LAT_S = 2e-6             # NVLink 4 hop through an NVSwitch (estimate)
NODE_BW = 900e9              # bytes/s, NVLink 4 (NVIDIA H100 data sheet)
NODE_LAT_S = 2e-6            # NVLink 4 hop through an NVSwitch (estimate)
INTER_BW = 50e9              # bytes/s, one 400 Gb/s NDR InfiniBand port
                             # (NVIDIA ConnectX-7 data sheet)
INTER_LAT_S = 4e-6           # GPU, NIC, one NDR switch, NIC, GPU (estimate)

# -- TCO (cost-per-step) constants ------------------------------------------
# the JAX package's cost model, not an H100 price (NVIDIA publishes none)
ACCEL_COST_USD = 15_000.0    # per accelerator, incl. host/switch share
ACCEL_AMORT_S = 3 * 365 * 24 * 3600.0   # 3-year straight-line amortization
USD_PER_KWH = 0.10           # blended datacenter energy price

# device kinds with modeled semantics; ``kind`` is open-ended (any string
# works as a placement class), these are the conventional ones
DEVICE_KINDS = ("cpu", "accel", "dsp")


@dataclass(frozen=True)
class Device:
    """One execution resource on the SoC.

    ``kind`` is the placement class ``CostedOp.device_class`` matches
    against (``cpu`` | ``accel`` | ``dsp`` by convention).  Every
    ``None`` field inherits the flat ``EngineConfig`` value, so a bare
    ``Device("acc0")`` is exactly one of today's workers."""
    name: str
    kind: str = "accel"
    peak_flops: Optional[float] = None       # None -> EngineConfig.peak_flops
    datapath_scale: Optional[float] = None   # None -> EngineConfig value
    interface: Optional[str] = None          # None -> EngineConfig.interface
    hbm_bw: Optional[float] = None           # None -> link bw -> EngineConfig
    vmem_bw: Optional[float] = None          # None -> EngineConfig.vmem_bw
    link: Optional[str] = None               # Link name; None -> first link
    # per-device compute-cost backend (repro_torch.sim.backends); None inherits
    # EngineConfig.cost_backend (itself None = the native roofline math)
    cost_backend: Optional[object] = None


@dataclass(frozen=True)
class Link:
    """A shared data-movement resource (e.g. the HBM port pool).

    ``ports`` has the engine's contention semantics: active transfers on
    this link beyond ``ports`` share bandwidth (0 = uncontended,
    fractional values model a link narrower than one device's demand).
    ``bandwidth`` overrides the per-byte rate for devices on this link
    (``None`` inherits ``EngineConfig.hbm_bw``)."""
    name: str
    bandwidth: Optional[float] = None        # None -> EngineConfig.hbm_bw
    ports: Optional[float] = None            # None -> EngineConfig.hbm_ports



# one H100 as a device of a topology, every rate spelled out (a bare
# ``Device("acc0")`` inherits the same values from ``EngineConfig()``)
H100 = Device("h100", kind="accel", peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW,
              vmem_bw=VMEM_BW)

_DEFAULT_LINK = Link("shared")


@dataclass(frozen=True)
class SoCTopology:
    """Devices + links: the heterogeneous SoC the engine schedules onto.

    A topology with no ``links`` declared has one implicit shared link
    inheriting every ``EngineConfig`` value — today's single HBM port
    pool.  Ops are placed on the devices whose ``kind`` equals their
    ``device_class``; a class with no matching device falls back to the
    accelerators (and then to every device), so programs tagged for a
    richer SoC still run on a smaller one."""
    devices: Tuple[Device, ...]
    links: Tuple[Link, ...] = ()
    name: str = "soc"

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(self.devices))
        object.__setattr__(self, "links", tuple(self.links))
        if not self.devices:
            raise ValueError("SoCTopology needs at least one device")
        names = [d.name for d in self.devices]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate device names in topology: {names}")
        lnames = [l.name for l in self.links]
        if len(set(lnames)) != len(lnames):
            raise ValueError(f"duplicate link names in topology: {lnames}")
        known = set(lnames)
        for d in self.devices:
            if d.link is not None and d.link not in known:
                raise ValueError(
                    f"device {d.name!r} references unknown link {d.link!r}")

    # -- construction -------------------------------------------------------

    @classmethod
    def homogeneous(cls, n_workers: int, name: str = "") -> "SoCTopology":
        """The homogeneous expansion of a flat config: ``n_workers``
        identical accelerators (every field inherited) on one implicit
        shared link — bit-identical to the flat config.

        Memoized on the worker count (every ``run()`` of a flat config
        resolves one, and the frozen instances are safely shareable), so
        small-program runs don't pay device construction + validation."""
        n = max(int(n_workers), 1)
        if name:
            return cls(devices=tuple(Device(f"acc{i}") for i in range(n)),
                       name=name)
        return _homogeneous_cached(n)

    # -- queries ------------------------------------------------------------

    def devices_of(self, kind: str) -> Tuple[Device, ...]:
        return tuple(d for d in self.devices if d.kind == kind)

    @property
    def n_accel(self) -> int:
        return sum(1 for d in self.devices if d.kind == "accel")

    def kind_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.devices:
            out[d.kind] = out.get(d.kind, 0) + 1
        return out

    def describe(self) -> str:
        """Compact label like ``1cpu+4accel`` (device-order stable)."""
        counts = self.kind_counts()
        return "+".join(f"{c}{k}" for k, c in counts.items())

    def candidate_indices(self, device_class: str) -> Tuple[int, ...]:
        """Device indices an op of ``device_class`` may be placed on:
        exact kind match, else the accelerators, else every device."""
        idx = tuple(i for i, d in enumerate(self.devices)
                    if d.kind == device_class)
        if not idx:
            idx = tuple(i for i, d in enumerate(self.devices)
                        if d.kind == "accel")
        if not idx:
            idx = tuple(range(len(self.devices)))
        return idx

    def link_for(self, device: Device) -> Link:
        """The link this device's transfers traverse (declared by name,
        else the topology's first link, else the implicit shared one)."""
        if device.link is not None:
            for l in self.links:
                if l.name == device.link:
                    return l
        return self.links[0] if self.links else _DEFAULT_LINK


@lru_cache(maxsize=128)
def _homogeneous_cached(n: int) -> SoCTopology:
    return SoCTopology(devices=tuple(Device(f"acc{i}") for i in range(n)),
                       name=f"{n}accel")


# ---------------------------------------------------------------------------
# continuous hardware-parameter vector <-> EngineConfig mapping
#
# The analytic chain terms (``repro_torch.sim.costmodel``) treat a design
# point as a flat float vector over these fields; everything else on the config
# (interface choice, energy constants, tile thresholds) is categorical
# and stays fixed within a batch.  ``host_threads``/``hbm_ports`` are
# kept continuous here — the engine only ever divides by them, so a
# fractional value is a perfectly well-defined (if physically idealized)
# design point.

PARAM_FIELDS: Tuple[str, ...] = (
    "peak_flops", "datapath_scale", "hbm_bw", "vmem_bw", "ici_bw",
    "hbm_ports", "host_dispatch_s", "host_bw", "host_threads",
    "ici_lat_s", "node_bw", "node_lat_s", "inter_bw", "inter_lat_s")

ParamsLike = Union[Mapping[str, float], Sequence[float]]


def params_from_config(config) -> Tuple[float, ...]:
    """The ``PARAM_FIELDS`` vector of an ``EngineConfig``-like object (any
    object carrying the continuous fields), as plain floats in field
    order."""
    return tuple(float(getattr(config, f)) for f in PARAM_FIELDS)


def params_dict(params: ParamsLike) -> Dict[str, float]:
    """Normalize a params mapping/sequence to a ``{field: float}`` dict
    (sequences must be full-length and are zipped against PARAM_FIELDS)."""
    if isinstance(params, Mapping):
        unknown = set(params) - set(PARAM_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown hardware parameters {sorted(unknown)}; "
                f"continuous fields are {PARAM_FIELDS}")
        return {k: float(v) for k, v in params.items()}
    vals = list(params)
    if len(vals) != len(PARAM_FIELDS):
        raise ValueError(
            f"expected {len(PARAM_FIELDS)} values in PARAM_FIELDS order, "
            f"got {len(vals)}")
    return {k: float(v) for k, v in zip(PARAM_FIELDS, vals)}


def apply_params(config, params: ParamsLike):
    """A copy of ``config`` with the given continuous fields installed.

    ``params`` is either a ``{field: value}`` mapping (partial is fine)
    or a full vector in ``PARAM_FIELDS`` order.  Values stay floats —
    see the module note on continuous ``host_threads``/``hbm_ports`` —
    so the exact engine prices precisely the point the analytic model
    evaluated.  Explicit per-device/per-link overrides in
    ``config.topology`` are NOT rewritten (the flat fields are only
    inheritance defaults there); use ``with_ports`` for the port study."""
    return replace(config, **params_dict(params))


def with_ports(topo: SoCTopology, ports: float) -> SoCTopology:
    """A copy of ``topo`` with every link's ``ports`` set to ``ports``
    (an implicit shared link is made explicit first) — the knob the
    Fig-13-style port studies turn."""
    links = topo.links if topo.links else (_DEFAULT_LINK,)
    return replace(topo, links=tuple(replace(l, ports=float(ports))
                                     for l in links))


# ---------------------------------------------------------------------------
# hierarchical fabric: the cluster-scale generalization of ``Link``
#
# An ``SoCTopology`` models the devices *inside* one SoC; a ``Fabric``
# models the interconnect hierarchy *between* accelerators at cluster
# scale.  Tiers are listed innermost-first — e.g. 4 accelerators per
# chip on ICI, 8 chips per node on board-level links, N nodes behind
# NIC/switch — and each tier is a (latency, bandwidth) pair.  A tier
# whose ``bandwidth``/``latency_s`` is ``None`` inherits the flat
# ``EngineConfig`` field named by ``TIER_FIELDS`` (the same inheritance
# convention ``Device``/``Link`` use), which keeps fabric rates among the
# continuous ``PARAM_FIELDS``.

TIER_NAMES: Tuple[str, ...] = ("ici", "node", "inter")

# tier name -> (EngineConfig bandwidth field, latency field)
TIER_FIELDS: Dict[str, Tuple[str, str]] = {
    "ici": ("ici_bw", "ici_lat_s"),
    "node": ("node_bw", "node_lat_s"),
    "inter": ("inter_bw", "inter_lat_s"),
}


@dataclass(frozen=True)
class FabricTier:
    """One level of the interconnect hierarchy.

    ``group_size`` is how many units of the tier below this tier groups
    (for the innermost tier: accelerators per group).  ``None`` rates
    inherit the flat ``EngineConfig`` fields for this tier name."""
    name: str
    group_size: int
    bandwidth: Optional[float] = None        # None -> EngineConfig field
    latency_s: Optional[float] = None        # None -> EngineConfig field


@dataclass(frozen=True)
class Fabric:
    """Hierarchical interconnect: tiers innermost-first.

    Accelerators are numbered 0..n_accel-1 in tier order, innermost
    fastest-varying: with tiers ``ici(4), node(8), inter(2)`` ranks
    0-3 share a chip, 0-31 share a node.  ``span_tier(members)`` gives
    the outermost tier a member set crosses — the bottleneck tier a flat
    collective over those members runs on.  ``lane(members, t)`` names
    the contended engine lane: collectives sharing a tier AND a leading
    member contend (same physical links); disjoint groups on the same
    tier proceed in parallel."""
    tiers: Tuple[FabricTier, ...]
    name: str = "fabric"

    def __post_init__(self):
        object.__setattr__(self, "tiers", tuple(self.tiers))
        if not self.tiers:
            raise ValueError("Fabric needs at least one tier")
        order = [TIER_NAMES.index(t.name) if t.name in TIER_NAMES else -1
                 for t in self.tiers]
        if -1 in order:
            bad = [t.name for t in self.tiers if t.name not in TIER_NAMES]
            raise ValueError(
                f"unknown fabric tier names {bad}; tiers are named from "
                f"{TIER_NAMES} (innermost-first)")
        if sorted(order) != order or len(set(order)) != len(order):
            raise ValueError(
                f"fabric tiers must be innermost-first in {TIER_NAMES} "
                f"order, got {[t.name for t in self.tiers]}")
        for t in self.tiers:
            if int(t.group_size) < 1:
                raise ValueError(
                    f"tier {t.name!r} group_size must be >= 1, "
                    f"got {t.group_size}")

    # -- construction -------------------------------------------------------

    @classmethod
    def single_tier(cls, n_accel: int, *, bandwidth: Optional[float] = None,
                    latency_s: Optional[float] = None,
                    name: str = "soc") -> "Fabric":
        """One flat ICI tier over ``n_accel`` accelerators — the fabric
        equivalent of the single shared collective lane (bit-identical to
        it at zero ICI latency, ``EngineConfig(ici_lat_s=0.0)``)."""
        return cls(tiers=(FabricTier("ici", max(int(n_accel), 1),
                                     bandwidth=bandwidth,
                                     latency_s=latency_s),),
                   name=name)

    @classmethod
    def cluster(cls, n_accel: int, *, accels_per_chip: int = 4,
                chips_per_node: int = 8, name: str = "") -> "Fabric":
        """A fabric covering ``n_accel`` accelerators with the canonical
        three tiers, sized bottom-up: ICI groups of ``accels_per_chip``,
        board-level node groups of ``chips_per_node`` chips, and as many
        NIC/switch-connected nodes as it takes to cover ``n_accel``.
        Small counts drop the unused outer tiers."""
        n = max(int(n_accel), 1)
        if n <= accels_per_chip:
            tiers = (FabricTier("ici", n),)
        elif n <= accels_per_chip * chips_per_node:
            tiers = (FabricTier("ici", accels_per_chip),
                     FabricTier("node", -(-n // accels_per_chip)))
        else:
            per_node = accels_per_chip * chips_per_node
            tiers = (FabricTier("ici", accels_per_chip),
                     FabricTier("node", chips_per_node),
                     FabricTier("inter", -(-n // per_node)))
        return cls(tiers=tiers, name=name or f"{n}accel-cluster")

    # -- queries ------------------------------------------------------------

    @property
    def n_accel(self) -> int:
        out = 1
        for t in self.tiers:
            out *= int(t.group_size)
        return out

    def leaves_per_group(self) -> Tuple[int, ...]:
        """Cumulative products: ``leaves_per_group()[t]`` accelerators
        form one group at tier ``t``."""
        out, acc = [], 1
        for t in self.tiers:
            acc *= int(t.group_size)
            out.append(acc)
        return tuple(out)

    def span_tier(self, members: Sequence[int]) -> int:
        """Index of the outermost tier ``members`` crosses: the smallest
        ``t`` with every member in the same tier-``t`` group (the whole
        fabric is one group at the top tier)."""
        ms = [int(m) for m in members]
        if not ms:
            raise ValueError("span_tier needs at least one member")
        if max(ms) >= self.n_accel or min(ms) < 0:
            raise ValueError(
                f"members {min(ms)}..{max(ms)} out of range for "
                f"{self.n_accel}-accelerator fabric")
        for t, per in enumerate(self.leaves_per_group()):
            if all(m // per == ms[0] // per for m in ms):
                return t
        return len(self.tiers) - 1

    def lane(self, members: Sequence[int],
             tier_idx: Optional[int] = None) -> str:
        """Engine lane name for a collective over ``members``:
        ``"<tier>:<min member>"``.  Same tier + same leading member =>
        same physical links => contention; disjoint groups get distinct
        lanes and run in parallel."""
        t = self.span_tier(members) if tier_idx is None else int(tier_idx)
        return f"{self.tiers[t].name}:{min(int(m) for m in members)}"

    def has_overrides(self) -> bool:
        """Whether any tier pins an explicit rate (instead of inheriting
        the flat config fields the analytic model vectorizes over)."""
        return any(t.bandwidth is not None or t.latency_s is not None
                   for t in self.tiers)

    def describe(self) -> str:
        """Compact label like ``4ici x 8node x 2inter``."""
        return " x ".join(f"{t.group_size}{t.name}" for t in self.tiers)


def resolve_tier_params(config, tier: str) -> Tuple[float, float]:
    """(latency_s, bandwidth) the engine charges per hop on ``tier``.

    An explicit rate on the matching ``config.fabric`` tier wins; ``None``
    falls back to the flat ``EngineConfig`` fields named by
    ``TIER_FIELDS`` — the same inheritance convention as ``Device`` and
    ``Link``, and what keeps fabric rates inside the continuous
    ``PARAM_FIELDS`` design vector."""
    if tier not in TIER_FIELDS:
        raise ValueError(
            f"unknown fabric tier {tier!r}; tiers are named from "
            f"{TIER_NAMES}")
    bw_field, lat_field = TIER_FIELDS[tier]
    bw = float(getattr(config, bw_field))
    lat = float(getattr(config, lat_field))
    fab = getattr(config, "fabric", None)
    if fab is not None:
        for t in fab.tiers:
            if t.name == tier:
                if t.bandwidth is not None:
                    bw = float(t.bandwidth)
                if t.latency_s is not None:
                    lat = float(t.latency_s)
                break
    return lat, bw


def tco_per_step(n_accel: int, step_time_s: float,
                 energy_j: float) -> float:
    """Amortized USD cost of one training step on ``n_accel``
    accelerators: straight-line capex over ``ACCEL_AMORT_S`` plus energy
    at ``USD_PER_KWH``.  The TCO column of the cluster sweeps."""
    capex = n_accel * ACCEL_COST_USD / ACCEL_AMORT_S * step_time_s
    energy = energy_j / 3.6e6 * USD_PER_KWH
    return capex + energy
