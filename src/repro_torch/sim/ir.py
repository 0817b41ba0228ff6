"""CostedOp IR — the single currency of the simulation engine.

A ``CostedOp`` carries everything the executor needs to place it in time:
compute (flops, with the dot share split out), data movement (operand and
result bytes, routed through the pluggable interface model), collective
traffic (operand-sum metric plus ring-model wire bytes), scheduling
structure (deps, reduction affinity), a ``device_class`` placement tag
(which kind of ``SoCTopology`` device may run it — host preprocessing on
the CPU, NN ops on the accelerators), fabric-tier fields the engine prices
per hop, and a reporting phase.

The port's copy of ``repro/sim/ir.py``'s core and two of its lowerings:

  from_graph          the declarative ``repro_torch.core.graph.Graph`` ->
                      tile-level ops via the dataflow tiling optimizer,
  from_tasks          ``TileTask`` lists (``core/scheduler.py``).

The reference's other lowerings (compiled HLO, decode, serving and
training steps, fabric collectives) are not copied yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

BYTES_PER_ELEM = 4  # graph tensors are fp32


@dataclass(frozen=True)
class CostedOp:
    name: str
    flops: float = 0.0
    dot_flops: float = 0.0          # matrix-unit share (can hide memory)
    bytes_in: float = 0.0           # operand bytes staged producer->consumer
    bytes_out: float = 0.0          # result bytes
    collective_bytes: float = 0.0   # operand-sum metric
    wire_bytes: float = 0.0         # ring-model per-device wire bytes
    transcendentals: float = 0.0
    deps: Tuple[str, ...] = ()
    affinity: Optional[str] = None  # same key -> same worker queue
    phase: str = ""                 # reporting group (layer / figure phase)
    # placement: which SoCTopology device kind may run this op ("cpu" |
    # "accel" | "dsp"); a class with no matching device falls back to the
    # accelerators, so flat configs behave exactly as before
    device_class: str = "accel"
    # explicit-time overrides (the TileTask lowering; None = derive from
    # flops/bytes and the engine's hardware model)
    duration_s: Optional[float] = None
    transfer_s: Optional[float] = None
    # fabric collectives: ``tier`` marks a per-hop transfer priced from the
    # named fabric tier's (latency, bandwidth) at run time — such ops
    # occupy only their ``lane`` (no worker placement, host dispatch or
    # compute).  ``lane`` is the contended serial resource the transfer
    # runs on ("ici" = the legacy single collective lane); ``hops``
    # multiplies the tier latency (a compressed run of back-to-back hops).
    tier: Optional[str] = None
    lane: str = "ici"
    hops: float = 1.0
    # microarchitecture pricing metadata (see ``repro_torch.sim.backends``):
    # the ``(M, N, K)`` compute-tile shape the op's dot work maps onto a
    # PE array, and the op family it lowered from ("matmul" | "conv" |
    # "").  Advisory — the default roofline backend never reads them;
    # lowerings without tile structure leave them empty.
    tile: Tuple[int, ...] = ()
    op_kind: str = ""

    @property
    def bytes(self) -> float:
        return self.bytes_in + self.bytes_out


_OP_FIELDS = frozenset(f.name for f in dataclasses.fields(CostedOp))


def replace(op, **changes):
    """``dataclasses.replace`` with a fast path for :class:`CostedOp`.

    Lowerings that stamp out op templates clone many ops (``Program.then``
    here; the reference's training and cluster lowerings by the hundred
    thousand); ``dataclasses.replace`` re-runs the frozen ``__init__`` — one guarded
    ``object.__setattr__`` per field — which dominates program
    construction.  ``CostedOp`` has no ``__post_init__`` and no derived
    state, so a shallow ``__dict__`` copy produces the identical frozen
    instance.  Unknown field names still raise ``TypeError`` like
    ``dataclasses.replace``; any other dataclass takes the stock path."""
    if type(op) is CostedOp:
        if not changes.keys() <= _OP_FIELDS:
            bad = sorted(changes.keys() - _OP_FIELDS)
            raise TypeError(f"replace() got unexpected CostedOp "
                            f"field(s) {bad}")
        new = object.__new__(CostedOp)
        new.__dict__.update(op.__dict__)
        new.__dict__.update(changes)
        return new
    return dataclasses.replace(op, **changes)


def linear_runs(ops: Sequence[CostedOp]) -> List[List[str]]:
    """Maximal linear runs of fabric hop ops: each interior link is a
    single-consumer -> single-dep edge between two ``tier`` ops that are
    LPT-neutral (``flops == 0`` and no pinned ``duration_s`` — the
    scheduling priority of such a hop is exactly 0.0 under every config,
    so contracting the link can never reorder the ready heap).

    These are the segments the engine's compiled plan contracts (the
    chain fast path generalized from whole-program to per-segment): along
    a run, finishing op ``i`` readies exactly its successor, so the event
    loop's behavior over the run is statically replayable.  Returns runs
    of length >= 2, in program order; single hop ops are not runs."""
    index = {op.name: i for i, op in enumerate(ops)}
    n_consumers = [0] * len(ops)
    sole_consumer = [-1] * len(ops)
    for i, op in enumerate(ops):
        for d in op.deps:
            j = index.get(d)
            if j is not None:
                n_consumers[j] += 1
                sole_consumer[j] = i

    def neutral(op: CostedOp) -> bool:
        return (op.tier is not None and op.flops == 0.0
                and op.duration_s is None)

    nxt = [-1] * len(ops)
    has_prev = [False] * len(ops)
    for i, op in enumerate(ops):
        if not neutral(op) or n_consumers[i] != 1:
            continue
        j = sole_consumer[i]
        succ = ops[j]
        if not neutral(succ) or len(succ.deps) != 1:
            continue
        nxt[i] = j
        has_prev[j] = True
    runs: List[List[str]] = []
    for i, op in enumerate(ops):
        if op.tier is None or has_prev[i] or nxt[i] < 0:
            continue
        run = [op.name]
        j = nxt[i]
        while j >= 0:
            run.append(ops[j].name)
            j = nxt[j]
        runs.append(run)
    return runs


@dataclass
class Program:
    ops: List[CostedOp]
    name: str = ""
    source: str = ""                # graph | hlo | tasks | custom
    meta: Dict = field(default_factory=dict)

    def __len__(self):
        return len(self.ops)

    # -- aggregates (the roofline inputs; preserved exactly by lowerings) ---
    def total(self, attr: str) -> float:
        return sum(getattr(op, attr) for op in self.ops)

    def totals(self) -> Dict[str, float]:
        # one pass over the ops; each accumulator adds left-to-right in op
        # order, so every sum is the same IEEE fold ``total()`` performs
        fl = dot = bi = bo = cb = wb = tc = 0.0
        for op in self.ops:
            fl += op.flops
            dot += op.dot_flops
            bi += op.bytes_in
            bo += op.bytes_out
            cb += op.collective_bytes
            wb += op.wire_bytes
            tc += op.transcendentals
        return {"flops": fl, "dot_flops": dot, "bytes_in": bi,
                "bytes_out": bo, "collective_bytes": cb, "wire_bytes": wb,
                "transcendentals": tc}

    def as_hlo_dict(self) -> Dict[str, float]:
        """Aggregate cost dict in the ``analyze_hlo`` schema — feeding this
        back to the closed-form wrappers reproduces the engine's terms."""
        t = self.totals()
        return {"flops": t["flops"], "dot_flops": t["dot_flops"],
                "bytes": t["bytes_in"] + t["bytes_out"],
                "collective_bytes": t["collective_bytes"],
                "wire_bytes": t["wire_bytes"],
                "transcendentals": t["transcendentals"],
                "collectives": {}, "n_while": 0, "custom_calls": {}}

    def then(self, other: "Program", name: str = "") -> "Program":
        """Sequential composition: ``other`` starts after this program's
        sinks complete (every root of ``other`` gains deps on our sinks)."""
        if not self.ops or not other.ops:
            return Program(self.ops + other.ops, name or self.name,
                           self.source)
        consumed = {d for op in self.ops for d in op.deps}
        sinks = tuple(op.name for op in self.ops if op.name not in consumed)
        other_names = {op.name for op in other.ops}
        bridged = [
            replace(op, deps=tuple(op.deps) + sinks)
            if not any(d in other_names for d in op.deps) else op
            for op in other.ops]
        return Program(self.ops + bridged,
                       name or f"{self.name}+{other.name}", "custom")


# ---------------------------------------------------------------------------
# lowering 1: declarative graph -> tile-level program


def _node_cost_parts(g, n, batch: int) -> Tuple[float, float, float]:
    """(flops, bytes_in, bytes_out) of one graph node at the given batch."""
    import numpy as np
    elems_out = int(np.prod(n.shape)) * batch // max(n.shape[0], 1)
    bytes_out = BYTES_PER_ELEM * elems_out
    if n.op == "convolution":
        k = n.attrs.get("kernel", 3)
        cin = n.attrs.get("cin", n.shape[-1])
        flops = 2.0 * elems_out * k * k * cin
        return flops, bytes_out, bytes_out        # act in ~ act out (same HW)
    if n.op == "matmul":
        cin = n.attrs.get("cin", n.shape[-1])
        flops = 2.0 * elems_out * cin
        bytes_in = BYTES_PER_ELEM * (elems_out + cin * n.shape[-1])
        return flops, bytes_in, bytes_out
    return float(elems_out), bytes_out, bytes_out  # elementwise / pool / norm


def from_graph(g, batch: int = 1, max_tile_elems: int = 16384,
               device_class: str = "accel", target=None) -> Program:
    """Lower a ``repro_torch.core.graph.Graph`` to a tile-level Program.

    Each op is tiled by the dataflow tiling optimizer; tile *i* of a node
    depends on tile *i* of each producer (wavefront pipelining — consumers
    start as soon as the matching producer tile lands).  Convolution tiles
    that cut the reduction dim share an affinity key: their partial sums
    reduce in place on one worker queue (the paper's Fig 14 effect).

    ``device_class`` is the placement tag every lowered op carries: NN
    graphs target the accelerators (the default); a preprocessing /
    frontend graph can be lowered onto the ``"cpu"`` or ``"dsp"`` device
    of a heterogeneous ``SoCTopology``.

    ``target`` is the :class:`repro_torch.core.tiling.TilingTarget` the
    tiles are chosen for (``None``: the H100's).
    """
    import numpy as np

    from repro_torch.core.tensor import TensorSpec
    from repro_torch.core.tiling import H100, choose_tiling

    ops: List[CostedOp] = []
    n_tiles_of: Dict[str, int] = {}
    for name in g.order:
        n = g.nodes[name]
        if n.op in ("input", "weight"):
            continue
        # resolve real kernel/cin from the weight operand when present
        if n.op in ("convolution", "matmul") and len(n.inputs) > 1:
            wshape = g.nodes[n.inputs[1]].shape
            if n.op == "convolution":
                n.attrs.setdefault("kernel", wshape[0])
                n.attrs.setdefault("cin", wshape[2])
            else:
                n.attrs.setdefault("cin", wshape[0])
        flops, bytes_in, bytes_out = _node_cost_parts(g, n, batch)
        shape4 = tuple(n.shape) if len(n.shape) == 4 else \
            (1, 1, 1, int(np.prod(n.shape)))
        tiling = choose_tiling(
            TensorSpec(shape4, "NHWC", "float32"), max_tile_elems,
            reduce_dim="C" if n.op in ("convolution", "matmul") else None,
            target=H100 if target is None else target)
        n_tiles = max(tiling.n_tiles, 1)
        n_tiles_of[name] = n_tiles
        reduce_aff = "C" in tiling.strategy and n.op == "convolution"
        # (M, N, K) compute-tile metadata for the systolic cost backend:
        # M output rows (spatial elems of one tile), N output channels of
        # the tile, K the reduction depth (im2col-expanded for convs)
        op_kind = ("conv" if n.op == "convolution"
                   else "matmul" if n.op == "matmul" else "")
        tile_meta: Tuple[int, ...] = ()
        if op_kind:
            ts = tiling.tile_shape
            kern = int(n.attrs.get("kernel", 1)) if op_kind == "conv" \
                else 1
            cin = int(n.attrs.get("cin", shape4[3]))
            tile_meta = (int(ts[0] * ts[1] * ts[2]), int(ts[3]),
                         kern * kern * cin)
        producers = [d for d in n.inputs
                     if d in g.nodes and g.nodes[d].op not in
                     ("input", "weight")]
        for i in range(n_tiles):
            deps = tuple(
                f"{d}/t{min(i, n_tiles_of.get(d, 1) - 1)}"
                for d in producers)
            ops.append(CostedOp(
                name=f"{name}/t{i}",
                flops=flops / n_tiles,
                dot_flops=(flops / n_tiles
                           if n.op in ("convolution", "matmul") else 0.0),
                bytes_in=bytes_in / n_tiles,
                bytes_out=bytes_out / n_tiles,
                deps=deps,
                affinity=(name if reduce_aff else None),
                phase=name,
                device_class=device_class,
                tile=tile_meta,
                op_kind=op_kind))
    return Program(ops, name=g.name, source="graph",
                   meta={"batch": batch, "max_tile_elems": max_tile_elems})


# ---------------------------------------------------------------------------
# lowering 2: TileTask lists (scheduler)


def from_tasks(tasks: Sequence, name: str = "tasks") -> Program:
    """Lower ``core.scheduler.TileTask``s, preserving their explicit times."""
    ops = [CostedOp(name=t.name,
                    duration_s=float(t.duration),
                    transfer_s=float(t.transfer) if t.transfer else 0.0,
                    deps=tuple(t.deps),
                    affinity=t.affinity,
                    phase=t.name.split("/")[0])
           for t in tasks]
    return Program(ops, name=name, source="tasks")
