"""CostedOp IR — the single currency of the simulation engine.

A ``CostedOp`` carries everything the executor needs to place it in time:
compute (flops, with the dot share split out), data movement (operand and
result bytes, routed through the pluggable interface model), collective
traffic (operand-sum metric plus ring-model wire bytes), scheduling
structure (deps, reduction affinity), a ``device_class`` placement tag
(which kind of ``SoCTopology`` device may run it — host preprocessing on
the CPU, NN ops on the accelerators), fabric-tier fields the engine prices
per hop, and a reporting phase.

The port's copy of ``repro/sim/ir.py``'s core and six of its lowerings:

  from_graph          the declarative ``repro_torch.core.graph.Graph`` ->
                      tile-level ops via the dataflow tiling optimizer,
  from_hlo            a cost dict in ``core.hlo``'s schema (``analyze_hlo``
                      of saved XLA text, or ``analyze_step`` of a traced
                      torch step) -> a chain of uniform macro-ops,
  from_decode         token-by-token decode of a ``ModelConfig`` -> a
                      per-token macro-op chain,
  from_serving_step   one serving-scheduler iteration -> a <=2-op batched
                      step (with ``serving_step_signature`` and
                      ``positions_for_signature``, the memo's key),
  from_training_step  one optimizer step (forward, backward at 2x the
                      forward FLOPs with activation re-reads, the
                      data-parallel gradient all-reduce, the AdamW
                      update) -> a <=4-op chain, for the whole model or
                      one pipeline stage's layer share; with a fabric,
                      TP and DP collectives as per-hop transfers,
  from_tasks          ``TileTask`` lists (``core/scheduler.py``).

``from_collective`` lowers one collective (all-reduce / reduce-scatter /
all-gather / all-to-all) over a group of accelerators on a hierarchical
``hw.Fabric`` into per-hop transfer ops: each step of ring / tree /
hierarchical is one ``CostedOp`` whose ``tier`` is the fabric tier it
crosses and whose ``lane`` names the contended link set; the engine prices
it as ``hops * tier_latency + collective_bytes / tier_bandwidth``.
``collective_time`` is the same price without the engine.  The
single-tier identities of the reference hold at ``ici_lat_s=0`` (the TPU
v5e's value); the port's default is the H100's NVLink hop, 2 us.

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

    The training and cluster lowerings clone hundreds of thousands of ops
    per sweep (segment templates stamped out per stage and microbatch);
    ``dataclasses.replace`` re-runs the frozen ``__init__`` — one guarded
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
# lowering 2: analyzed compiled HLO -> macro-op chain


def from_hlo(hlo: Dict, n_ops: int = 8, name: str = "") -> Program:
    """Lower an ``analyze_hlo`` cost dict to a chain of uniform macro-ops.

    The compiled module is one fused step — per-instruction structure is not
    recoverable from the aggregate dict — so the program is ``n_ops``
    proportional slices executed in sequence.  All aggregates (flops, bytes,
    collective/wire bytes) are preserved exactly, so the engine's roofline
    and breakdown equal the closed-form values by construction.
    """
    n_ops = max(int(n_ops), 1)
    flops = float(hlo.get("flops", 0.0))
    dot = float(hlo.get("dot_flops", 0.0))
    nbytes = float(hlo.get("bytes", 0.0))
    coll = float(hlo.get("collective_bytes", 0.0))
    # ring-model wire bytes when the analyzer produced them; the raw operand
    # sum is the fallback ONLY when the key is absent (hand-written dicts) —
    # a legitimate 0.0 (e.g. group-size-1 collectives) must stay 0.0
    wire = float(hlo["wire_bytes"]) if "wire_bytes" in hlo else coll
    trans = float(hlo.get("transcendentals", 0.0))
    ops = []
    for i in range(n_ops):
        ops.append(CostedOp(
            name=f"step/{i}",
            flops=flops / n_ops,
            dot_flops=dot / n_ops,
            bytes_in=0.5 * nbytes / n_ops,
            bytes_out=0.5 * nbytes / n_ops,
            collective_bytes=coll / n_ops,
            wire_bytes=wire / n_ops,
            transcendentals=trans / n_ops,
            deps=(f"step/{i-1}",) if i else (),
            phase="step",
            device_class="accel"))
    return Program(ops, name=name or hlo.get("entry", "hlo"), source="hlo",
                   meta={"n_ops": n_ops})


# ---------------------------------------------------------------------------
# lowering 2b: autoregressive decode -> per-token macro-op chain


def _decode_terms(cfg, bytes_per_param: float
                  ) -> Tuple[float, float, int, float]:
    """(active params, per-layer KV width, attention layer count, streamed
    weight bytes) of a ``ModelConfig``: the accounting behind
    ``from_decode``.

    The KV width is ``n_kv_heads * head_dim`` elements per layer; a token
    at cache position ``p`` costs ``4 * n_attn_layers * kv_dim * p`` flops
    (QK^T + AV over K and V) and re-reads ``2 * n_attn_layers * kv_dim * p``
    cached elements.  SSM families (and hybrids outside their shared
    attention block) carry no growing KV term.
    """
    n_active = float(cfg.active_param_count())
    kv_dim = 0.0
    n_attn_layers = 0
    if getattr(cfg, "n_kv_heads", 0) and getattr(cfg, "family", "") != "ssm":
        kv_dim = float(cfg.n_kv_heads * cfg.resolved_head_dim)
        n_attn_layers = (cfg.n_layers // cfg.hybrid_attn_every
                         if cfg.family == "hybrid" else cfg.n_layers)
    return n_active, kv_dim, n_attn_layers, n_active * bytes_per_param


def from_decode(cfg, n_tokens: int, *, seq_len: int = 1024, batch: int = 1,
                ops_per_token: int = 8, bytes_per_param: float = 2.0,
                name: str = "") -> Program:
    """Lower token-by-token decode of a ``ModelConfig`` to a chain Program.

    Every generated token streams the full (active) weight set and re-reads
    a KV cache that grows with position: the canonical memory-bound serial
    workload (and, at several ops per token over hundreds of tokens, the
    multi-thousand-op chain that stresses the executor).  Token ``t`` is
    ``ops_per_token`` uniform macro-op slices chained back-to-back, phase
    ``tok<t>``; a token costs 2·N_active flops a sequence plus the KV
    re-read term.
    """
    n_tokens = max(int(n_tokens), 1)
    ops_per_token = max(int(ops_per_token), 1)
    n_active, kv_dim, n_attn_layers, weight_bytes = \
        _decode_terms(cfg, bytes_per_param)
    ops: List[CostedOp] = []
    prev: Optional[str] = None
    for t in range(n_tokens):
        pos = seq_len + t
        flops = 2.0 * n_active * batch \
            + 4.0 * n_attn_layers * kv_dim * pos * batch
        kv_bytes = 2.0 * n_attn_layers * kv_dim * pos * bytes_per_param \
            * batch
        bytes_in = weight_bytes + kv_bytes
        bytes_out = kv_dim * n_attn_layers * bytes_per_param * batch
        for k in range(ops_per_token):
            nm = f"tok{t}/s{k}"
            ops.append(CostedOp(
                name=nm,
                flops=flops / ops_per_token,
                dot_flops=flops / ops_per_token,
                bytes_in=bytes_in / ops_per_token,
                bytes_out=bytes_out / ops_per_token,
                deps=(prev,) if prev else (),
                phase=f"tok{t}",
                device_class="accel"))
            prev = nm
    return Program(ops, name=name or f"{getattr(cfg, 'name', 'model')}"
                   f"/decode{n_tokens}", source="decode",
                   meta={"n_tokens": n_tokens, "seq_len": seq_len,
                         "batch": batch, "ops_per_token": ops_per_token})


# ---------------------------------------------------------------------------
# lowering 2c: one serving-scheduler iteration -> batched step program


def from_serving_step(cfg, *, prefill_lens: Sequence[int] = (),
                      decode_positions: Sequence[int] = (),
                      step: int = 0, bytes_per_param: float = 2.0,
                      name: str = "") -> Program:
    """Lower ONE serving-scheduler iteration to a <=2-op step Program.

    A continuous-batching model step does two things in a single forward
    pass: it prefills the requests admitted this iteration and decodes one
    token for every request already live.  The lowering mirrors that:

      ``step<k>/prefill``  batched prefill of ``prefill_lens`` prompts —
                           ``sum(L_j)`` tokens of dense compute plus the
                           causal attention term
                           ``4 * n_attn * kv_dim * L_j*(L_j-1)/2`` per
                           prompt, writing ``L_j`` KV entries each;
      ``step<k>/decode``   one token per entry of ``decode_positions``
                           (the per-request KV length) — per slot the same
                           ``from_decode`` accounting: ``2*N_active`` dense
                           flops plus ``4 * n_attn * kv_dim * p`` attention
                           flops and a ``2 * n_attn * kv_dim * p`` element
                           KV re-read.

    The full streamed weight set (``N_active * bytes_per_param``) is
    charged ONCE per step, on the step's first op — this is the weight
    amortization that makes batched decode pay off: the memory-bound cost
    of a step is nearly flat in batch size while its token yield scales
    with it.  Padded slots (static batching) are modeled by passing their
    positions in ``decode_positions`` even though they yield no token —
    the cost of computing garbage is real.

    ``repro_torch.sim.serving`` chains these step programs (each step's
    first op depends on the previous step's last op) into one served-trace
    Program; the result is a pure linear chain, so the engine's prefix-sum
    fast path applies to whole-trace runs.
    """
    n_active, kv_dim, n_attn, weight_bytes = \
        _decode_terms(cfg, bytes_per_param)
    kv_entry = kv_dim * n_attn * bytes_per_param     # one token's KV write
    ops: List[CostedOp] = []
    prev: Optional[str] = None
    if prefill_lens:
        n_tok = float(sum(prefill_lens))
        attn = sum(4.0 * n_attn * kv_dim * (L * (L - 1) // 2)
                   for L in prefill_lens)
        flops = 2.0 * n_active * n_tok + attn
        prev = f"step{step}/prefill"
        ops.append(CostedOp(
            name=prev, flops=flops, dot_flops=flops,
            bytes_in=weight_bytes,
            bytes_out=kv_entry * n_tok,
            phase=f"step{step}",
            device_class="accel",
            ))
    if decode_positions:
        batch = float(len(decode_positions))
        pos_sum = float(sum(decode_positions))
        flops = 2.0 * n_active * batch + 4.0 * n_attn * kv_dim * pos_sum
        kv_read = 2.0 * n_attn * kv_dim * pos_sum * bytes_per_param
        ops.append(CostedOp(
            name=f"step{step}/decode", flops=flops, dot_flops=flops,
            bytes_in=(0.0 if prev else weight_bytes) + kv_read,
            bytes_out=kv_entry * batch,
            deps=(prev,) if prev else (),
            phase=f"step{step}",
            device_class="accel",
            ))
    return Program(ops, name=name or f"{getattr(cfg, 'name', 'model')}"
                   f"/step{step}", source="serving",
                   meta={"step": step,
                         "n_prefill": len(prefill_lens),
                         "n_decode": len(decode_positions)})


def serving_step_signature(prefill_lens: Sequence[int],
                           decode_positions: Sequence[int]) -> Tuple:
    """The cost-sufficient signature of one serving step.

    ``from_serving_step`` reads ``decode_positions`` only through ``len()``
    (the decode batch size) and ``sum()`` (the KV position total, an exact
    integer sum), while the prefill ops' causal-attention term is a float
    sum over the *individual* prompt lengths — so ``(tuple(prefill_lens),
    len(decode_positions), sum(decode_positions))`` determines every cost
    field of the step's ops bit-for-bit.  The step index only names ops;
    it never changes a cost.  ``serving.StepCostTable`` memoizes step
    pricing on this key, and this function is the single place that
    encodes the coupling — extend it if ``from_serving_step`` ever reads
    more structure out of ``decode_positions``.
    """
    return (tuple(prefill_lens), len(decode_positions),
            int(sum(decode_positions)))


def positions_for_signature(n_decode: int, pos_sum: int) -> Tuple[int, ...]:
    """A canonical ``decode_positions`` tuple realizing a signature's
    ``(n_decode, pos_sum)`` — any tuple with that length and sum lowers to
    bit-identical decode-op costs (see ``serving_step_signature``)."""
    if n_decode <= 0:
        return ()
    return (int(pos_sum) - (n_decode - 1),) + (1,) * (n_decode - 1)


# ---------------------------------------------------------------------------
# lowering 2d: one training step -> fwd/bwd/reduce/update chain


# AdamW arithmetic per parameter (two moment EMAs, bias correction, weight
# decay, the update itself) — the constant the optimizer-update op charges
OPTIMIZER_FLOPS_PER_PARAM = 12.0
# backward pass = grad wrt activations + grad wrt weights: the canonical
# 2x-forward FLOP accounting (recomputation/remat would add a third pass)
BWD_FLOPS_MULT = 2.0


def partition_stages(n_layers: int, n_stages: int) -> Tuple[int, ...]:
    """Balanced layer partition for pipeline parallelism: the first
    ``n_layers % n_stages`` stages carry one extra layer.  The training
    simulator (``repro_torch.sim.training``) and ``from_training_step``
    take every stage's layer share from here."""
    n_layers, n_stages = int(n_layers), int(n_stages)
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_layers < n_stages:
        raise ValueError(
            f"cannot split {n_layers} layers over {n_stages} stages: "
            "every stage needs at least one layer")
    base, extra = divmod(n_layers, n_stages)
    return tuple(base + (1 if s < extra else 0) for s in range(n_stages))


# ---------------------------------------------------------------------------
# lowering: collectives -> per-hop fabric transfers
#
# Every algorithm step becomes one op on the lane of the fabric tier it
# crosses; steps chain, independent groups (distinct lanes) overlap.  On a
# homogeneous uncontended fabric the makespan is therefore the textbook
# closed form, asserted exactly in tests/test_collectives.py:
#
#   ring all-reduce       2*(p-1) steps of B/p   -> 2*(p-1)/p * B/bw
#                                                   + 2*(p-1)*lat
#   ring RS / AG          (p-1) steps of B/p     ->   (p-1)/p * B/bw
#                                                   + (p-1)*lat
#   tree all-reduce       2*ceil(log2 p) steps   -> 2*ceil(log2 p)
#                         of B                      * (lat + B/bw)
#   all-to-all            (p-1) pairwise steps   -> (p-1)*(lat + (B/p)/bw)
#                         of B/p
#   hierarchical          ring-RS within each sub-group, recursive
#   all-reduce            all-reduce of B/k across sub-group leads,
#                         ring-AG back — the composed per-tier bound.
#
# The k parallel shard-rings of the hierarchical cross-tier phase run on
# disjoint lanes with identical cost; the lowering emits the lead ring as
# their (equal-time) representative to keep programs small.

COLLECTIVE_KINDS = ("all_reduce", "reduce_scatter", "all_gather",
                    "all_to_all")
COLLECTIVE_ALGOS = ("ring", "tree", "hierarchical")


def _sinks(ops: Sequence[CostedOp]) -> Tuple[str, ...]:
    consumed = {d for op in ops for d in op.deps}
    return tuple(op.name for op in ops if op.name not in consumed)


def _hop_chain(prefix: str, n_steps: int, step_bytes: float, tier: str,
               lane: str, deps: Tuple[str, ...], phase: str,
               device_class: str, count: float) -> List[CostedOp]:
    """``n_steps`` chained per-hop transfers of ``step_bytes`` each on one
    lane; ``count`` compresses that many back-to-back collectives into the
    same ops (bytes and latency hops both scale — exact, since the steps
    serialize on the lane anyway)."""
    ops: List[CostedOp] = []
    for i in range(n_steps):
        nm = f"{prefix}/s{i}"
        ops.append(CostedOp(
            name=nm, collective_bytes=count * step_bytes,
            wire_bytes=count * step_bytes, tier=tier, lane=lane,
            hops=count, deps=deps if not ops else (ops[-1].name,),
            phase=phase, device_class=device_class))
    return ops


def _lower_collective(kind: str, nbytes: float, members: Tuple[int, ...],
                      fabric, prefix: str, deps: Tuple[str, ...],
                      phase: str, device_class: str,
                      count: float, algo: str) -> List[CostedOp]:
    p = len(members)
    if p <= 1:
        return []
    span = fabric.span_tier(members)
    tier = fabric.tiers[span].name
    lane = fabric.lane(members, span)
    if kind == "all_to_all":
        # pairwise exchange: each of the p-1 steps trades one B/p shard
        # with the k-th neighbor (algorithm choice does not change the
        # uncontended cost, so every algo lowers the same way)
        return _hop_chain(prefix, p - 1, nbytes / p, tier, lane, deps,
                          phase, device_class, count)
    if algo == "ring":
        steps = {"all_reduce": 2 * (p - 1), "reduce_scatter": p - 1,
                 "all_gather": p - 1}[kind]
        return _hop_chain(prefix, steps, nbytes / p, tier, lane, deps,
                          phase, device_class, count)
    if algo == "tree":
        depth = max(1, (p - 1).bit_length())   # ceil(log2 p)
        if kind == "all_reduce":
            # binomial reduce to the root + broadcast back: full payload
            # per level
            return _hop_chain(prefix, 2 * depth, nbytes, tier, lane, deps,
                              phase, device_class, count)
        # recursive halving (RS) / doubling (AG): level k moves B/2^k
        ops: List[CostedOp] = []
        sizes = [nbytes / (2 ** (k + 1)) for k in range(depth)]
        if kind == "all_gather":
            sizes.reverse()
        for i, sz in enumerate(sizes):
            nm = f"{prefix}/s{i}"
            ops.append(CostedOp(
                name=nm, collective_bytes=count * sz, wire_bytes=count * sz,
                tier=tier, lane=lane, hops=count,
                deps=deps if not ops else (ops[-1].name,),
                phase=phase, device_class=device_class))
        return ops
    if algo == "hierarchical":
        if kind != "all_reduce":
            raise ValueError(
                f"hierarchical lowering covers all_reduce only, got {kind}")
        if span == 0:
            return _lower_collective(kind, nbytes, members, fabric, prefix,
                                     deps, phase, device_class, count,
                                     "ring")
        per = fabric.leaves_per_group()[span - 1]
        groups: Dict[int, List[int]] = {}
        for m in members:
            groups.setdefault(m // per, []).append(m)
        subs = [tuple(sorted(g)) for g in groups.values()]
        if len(subs) == 1:
            return _lower_collective(kind, nbytes, members, fabric, prefix,
                                     deps, phase, device_class, count,
                                     "ring")
        k = len(subs[0])
        if any(len(s) != k for s in subs):
            raise ValueError(
                "hierarchical all_reduce needs uniform sub-groups per "
                f"tier, got sizes {[len(s) for s in subs]}")
        if k == 1:
            # nothing below the spanning tier: plain ring across members
            return _lower_collective(kind, nbytes, members, fabric, prefix,
                                     deps, phase, device_class, count,
                                     "ring")
        ops = []
        # phase 1: ring reduce-scatter inside every sub-group (parallel
        # lanes)
        for gi, sub in enumerate(subs):
            ops.extend(_lower_collective(
                "reduce_scatter", nbytes, sub, fabric, f"{prefix}/rs{gi}",
                deps, phase, device_class, count, "ring"))
        rs_sinks = _sinks(ops) if ops else deps
        # phase 2: all-reduce the B/k shard across the sub-group leads
        # (recursively hierarchical, so 3-tier fabrics compose)
        reps = tuple(s[0] for s in subs)
        up = _lower_collective("all_reduce", nbytes / k, reps, fabric,
                               f"{prefix}/up", rs_sinks, phase,
                               device_class, count, "hierarchical")
        ops.extend(up)
        up_sinks = _sinks(up) if up else rs_sinks
        # phase 3: ring all-gather back inside every sub-group
        for gi, sub in enumerate(subs):
            ops.extend(_lower_collective(
                "all_gather", nbytes, sub, fabric, f"{prefix}/ag{gi}",
                up_sinks, phase, device_class, count, "ring"))
        return ops
    raise ValueError(f"unknown collective algo {algo!r}; "
                     f"one of {COLLECTIVE_ALGOS}")


def from_collective(kind: str, nbytes: float, group, fabric=None, *,
                    algo: str = "ring", count: float = 1.0,
                    prefix: str = "", phase: str = "collective",
                    deps: Sequence[str] = (),
                    device_class: str = "accel",
                    name: str = "") -> Program:
    """Lower ONE collective over ``group`` into per-hop fabric transfers.

    ``group`` is a member-id sequence or a plain count (members ``0..p-1``);
    ``fabric`` defaults to a flat single-tier ICI fabric over the group.
    ``count`` compresses that many identical back-to-back collectives
    (e.g. one per transformer layer) into the same per-hop ops — bytes
    and latency hops scale together, so the cost is exact.  A 1-member
    group lowers to the empty Program (composing it via ``Program.then``
    is bit-identical to a no-op; asserted in tests/test_collectives.py).
    """
    from repro_torch.sim import hw
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}; "
                         f"one of {COLLECTIVE_KINDS}")
    if algo not in COLLECTIVE_ALGOS:
        raise ValueError(f"unknown collective algo {algo!r}; "
                         f"one of {COLLECTIVE_ALGOS}")
    members = (tuple(range(int(group))) if isinstance(group, int)
               else tuple(int(m) for m in group))
    if len(set(members)) != len(members):
        raise ValueError(f"duplicate members in collective group {members}")
    if fabric is None:
        fabric = hw.Fabric.single_tier(max(members) + 1 if members else 1)
    ops = _lower_collective(kind, float(nbytes), members, fabric,
                            prefix or kind, tuple(deps), phase,
                            device_class, float(count), algo)
    return Program(ops, name=name or f"{kind}/{algo}", source="collective",
                   meta={"kind": kind, "algo": algo, "nbytes": float(nbytes),
                         "group": members, "count": float(count),
                         "fabric": fabric.describe()})


def collective_time(kind: str, nbytes: float, group, fabric=None, *,
                    algo: str = "ring", count: float = 1.0,
                    config=None) -> float:
    """Uncontended analytic time of one collective: the longest
    dependency path over the lowered per-hop ops, priced from ``config``
    (default ``EngineConfig()``: one H100, whose ``ici_lat_s`` is 2 us)
    via ``hw.resolve_tier_params``.  Parallel sub-group chains live on
    disjoint lanes, so on an otherwise idle fabric the engine's makespan
    equals this bound exactly."""
    from repro_torch.sim import hw
    if config is None:
        from repro_torch.sim.engine import EngineConfig
        config = EngineConfig()
    prog = from_collective(kind, nbytes, group, fabric, algo=algo,
                           count=count)
    finish: Dict[str, float] = {}
    for op in prog.ops:    # lowering emits in topological order
        lat, bw = hw.resolve_tier_params(config, op.tier)
        cost = op.hops * lat + op.collective_bytes / bw
        start = max((finish[d] for d in op.deps if d in finish),
                    default=0.0)
        finish[op.name] = start + cost
    return max(finish.values(), default=0.0)


def _training_terms(cfg, seq_len: int, batch: int, bytes_per_param: float,
                    bytes_per_act: float) -> Dict[str, float]:
    """Whole-model per-step cost terms of one fwd+bwd over ``batch``
    sequences of ``seq_len`` tokens — the shared accounting behind
    ``from_training_step``.

      fwd_flops    dense ``2 * N_active * tokens`` plus the causal
                   attention term ``4 * n_attn * kv_dim * S*(S-1)/2`` per
                   sequence (the ``from_serving_step`` prefill formula),
      act_bytes    stored activations: one residual-stream tensor per
                   layer (``n_layers * d_model * tokens * bytes_per_act``),
                   written by the forward and re-read by the backward,
      weight_bytes streamed active weights (charged per pass — training
                   streams them forward AND backward),
      grad_bytes   dense gradient traffic (active params),
      opt_params   the full parameter count the optimizer state covers
                   (MoE: every expert has moments, not just routed ones).
    """
    n_active, kv_dim, n_attn, weight_bytes = \
        _decode_terms(cfg, bytes_per_param)
    tokens = float(batch) * float(seq_len)
    attn = 4.0 * n_attn * kv_dim * (seq_len * (seq_len - 1) // 2) * batch
    return {
        "fwd_flops": 2.0 * n_active * tokens + attn,
        "act_bytes": float(cfg.n_layers) * float(cfg.d_model) * tokens
        * bytes_per_act,
        "weight_bytes": weight_bytes,
        "grad_bytes": n_active * bytes_per_param,
        "opt_params": float(cfg.param_count()),
        "tokens": tokens,
    }


def from_training_step(cfg, *, seq_len: int = 1024, batch: int = 8,
                       stage: Optional[int] = None, n_stages: int = 1,
                       bytes_per_param: float = 2.0,
                       bytes_per_act: float = 2.0,
                       optimizer_bytes_per_param: float = 12.0,
                       dp_degree: int = 1, tp_degree: int = 1,
                       fabric=None, collective_algo: str = "ring",
                       overlap_dp: bool = False,
                       tp_group: Optional[Sequence[int]] = None,
                       dp_group: Optional[Sequence[int]] = None,
                       name: str = "") -> Program:
    """Lower ONE training optimizer step to a <=4-op chain Program.

    The chain is ``fwd -> bwd [-> reduce] -> update``:

      ``train/fwd``     forward over ``batch`` sequences: streams the
                        (active) weights, writes the stored activations;
      ``train/bwd``     backward at ``BWD_FLOPS_MULT`` (2x) the forward
                        FLOPs: re-streams the weights, RE-READS the stored
                        activations, writes the dense gradients;
      ``train/reduce``  the data-parallel gradient all-reduce, emitted only
                        when ``dp_degree > 1``: operand-sum metric =
                        gradient bytes, ring wire bytes =
                        ``2 * (d-1)/d * grad_bytes``;
      ``train/update``  the AdamW update: ``OPTIMIZER_FLOPS_PER_PARAM``
                        flops per (full, not active) parameter, reading the
                        gradients + optimizer state
                        (``optimizer_bytes_per_param`` covers fp32 m, v and
                        master weights) and writing the state back plus the
                        fresh streaming weights.

    ``stage``/``n_stages`` select one pipeline stage's share of the model:
    the layers partition via ``partition_stages`` and every term scales by
    ``layers_in_stage / n_layers`` (embeddings and the attention mix are
    apportioned uniformly — a deliberate first-order model).  ``stage=None``
    with ``n_stages=1`` is the whole model; the training simulator
    (``repro_torch.sim.training``) calls this per stage and per
    microbatch, so a 1-stage 1-microbatch simulated step is THIS chain,
    bit for bit.

    **Cluster placement** (``fabric`` given): compute, weights, gradients
    and optimizer state shard ``tp_degree``-ways (Megatron-style — the
    residual-stream activations stay replicated per TP rank), with two
    TP all-reduces per layer per pass lowered via ``from_collective``
    (compressed: ``count = 2 * layers``) after the forward and the
    backward; the DP gradient all-reduce becomes explicit per-hop
    transfers over ``dp_group`` with ``collective_algo``
    (ring / tree / hierarchical) instead of the legacy single
    ``train/reduce`` op.  ``overlap_dp`` starts the gradient all-reduce
    alongside the backward (grads stream out as bwd retires layers;
    first-order), with the update waiting on both.  ``tp_group`` /
    ``dp_group`` place the collectives on fabric member ids (defaults:
    TP ranks ``0..tp-1``, DP peers at stride ``tp_degree``).  With
    ``fabric=None`` the legacy <=4-op chain is produced bit-for-bit.
    """
    if n_stages > 1 and stage is None:
        raise ValueError("stage index required when n_stages > 1; use "
                         "repro_torch.sim.training for the full pipeline")
    tp = int(tp_degree)
    dp = int(dp_degree)
    if fabric is None:
        if tp != 1:
            raise ValueError(
                "tp_degree > 1 requires a fabric; pass "
                "hw.Fabric.single_tier(tp_degree * dp_degree) for a flat "
                "group")
        if overlap_dp:
            raise ValueError("overlap_dp requires a fabric")
    share = 1.0
    layers_here = float(cfg.n_layers)
    if stage is not None:
        layers = partition_stages(cfg.n_layers, n_stages)
        if not 0 <= stage < n_stages:
            raise ValueError(f"stage {stage} out of range for "
                             f"{n_stages} stages")
        share = layers[stage] / float(cfg.n_layers)
        layers_here = float(layers[stage])
    t = _training_terms(cfg, seq_len, batch, bytes_per_param, bytes_per_act)
    fwd_flops = t["fwd_flops"] * share
    act_bytes = t["act_bytes"] * share
    weight_bytes = t["weight_bytes"] * share
    grad_bytes = t["grad_bytes"] * share
    opt_params = t["opt_params"] * share
    if tp > 1:   # TP shards compute/weights/grads/state; acts replicate
        fwd_flops /= tp
        weight_bytes /= tp
        grad_bytes /= tp
        opt_params /= tp
    opt_state_bytes = opt_params * optimizer_bytes_per_param

    ops = [
        CostedOp(name="train/fwd", flops=fwd_flops, dot_flops=fwd_flops,
                 bytes_in=weight_bytes, bytes_out=act_bytes,
                 phase="fwd", device_class="accel"),
    ]
    fwd_side: Tuple[str, ...] = ("train/fwd",)
    tp_members: Tuple[int, ...] = ()
    if fabric is not None and tp > 1:
        tp_members = (tuple(int(m) for m in tp_group)
                      if tp_group is not None else tuple(range(tp)))
        if len(tp_members) != tp:
            raise ValueError(f"tp_group has {len(tp_members)} members "
                             f"for tp_degree={tp}")
        # two all-reduces per layer per pass over the residual stream
        tp_bytes = t["tokens"] * float(cfg.d_model) * bytes_per_act
        tpf = from_collective("all_reduce", tp_bytes, tp_members, fabric,
                              algo=collective_algo,
                              count=2.0 * layers_here,
                              prefix="train/tpf", phase="tp",
                              deps=fwd_side)
        ops.extend(tpf.ops)
        if tpf.ops:
            fwd_side = _sinks(tpf.ops)
    ops.append(
        CostedOp(name="train/bwd",
                 flops=BWD_FLOPS_MULT * fwd_flops,
                 dot_flops=BWD_FLOPS_MULT * fwd_flops,
                 bytes_in=weight_bytes + act_bytes,   # activation re-reads
                 bytes_out=grad_bytes,
                 deps=fwd_side, phase="bwd", device_class="accel"))
    bwd_side: Tuple[str, ...] = ("train/bwd",)
    if fabric is not None and tp > 1:
        tp_bytes = t["tokens"] * float(cfg.d_model) * bytes_per_act
        tpb = from_collective("all_reduce", tp_bytes, tp_members, fabric,
                              algo=collective_algo,
                              count=2.0 * layers_here,
                              prefix="train/tpb", phase="tp",
                              deps=bwd_side)
        ops.extend(tpb.ops)
        if tpb.ops:
            bwd_side = _sinks(tpb.ops)
    update_deps: Tuple[str, ...] = bwd_side
    if dp > 1:
        if fabric is None:
            ops.append(CostedOp(
                name="train/reduce",
                collective_bytes=grad_bytes,
                wire_bytes=2.0 * (dp - 1) / dp * grad_bytes,
                deps=bwd_side, phase="reduce", device_class="accel"))
            update_deps = ("train/reduce",)
        else:
            dp_members = (tuple(int(m) for m in dp_group)
                          if dp_group is not None
                          else tuple(d * tp for d in range(dp)))
            if len(dp_members) != dp:
                raise ValueError(f"dp_group has {len(dp_members)} members "
                                 f"for dp_degree={dp}")
            red = from_collective("all_reduce", grad_bytes, dp_members,
                                  fabric, algo=collective_algo,
                                  prefix="train/dp", phase="reduce",
                                  deps=fwd_side if overlap_dp else bwd_side)
            ops.extend(red.ops)
            red_sinks = _sinks(red.ops) if red.ops else ()
            if overlap_dp:
                update_deps = tuple(bwd_side) + red_sinks
            else:
                update_deps = red_sinks or bwd_side
    ops.append(CostedOp(
        name="train/update",
        flops=OPTIMIZER_FLOPS_PER_PARAM * opt_params,
        bytes_in=grad_bytes + opt_state_bytes,
        bytes_out=opt_state_bytes + weight_bytes,
        deps=update_deps, phase="opt", device_class="accel"))
    return Program(ops, name=name or f"{getattr(cfg, 'name', 'model')}"
                   f"/train", source="training",
                   meta={"seq_len": seq_len, "batch": batch,
                         "stage": stage, "n_stages": n_stages,
                         "dp_degree": dp_degree, "tp_degree": tp,
                         "share": share, "tokens": t["tokens"],
                         "collective_algo": collective_algo,
                         "overlap_dp": bool(overlap_dp),
                         "fabric": fabric.describe() if fabric is not None
                         else None})


# ---------------------------------------------------------------------------
# lowering 3: TileTask lists (scheduler)


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
