"""The port's trace reader: a step's FLOPs, bytes, collective bytes and
memory, in the schema of the JAX package's ``repro.core.hlo``.

Two entry points return the same dict (``flops``, ``dot_flops``,
``transcendentals``, ``bytes``, ``collective_bytes``, ``wire_bytes``,
``collectives`` {kind: {count, bytes}}, ``n_while``, ``custom_calls``):

``analyze_hlo(text)``   the reference's pure-Python analyzer of compiled
                        XLA HLO text, copied unchanged, so that the port
                        reads modules that other tools saved.  Its loop-tree
                        unsampling multiplies ``while`` bodies by their trip
                        counts (paper §II-E1).
``analyze_step(fn, *args, **kw)``
                        one call of a torch step traced on fake tensors
                        under a ``TorchDispatchMode``; see its docstring.

Costing model of ``analyze_hlo``:
  flops            dot/conv: exact from shapes; elementwise/reduce: #elems
  transcendentals  exp/log/tanh/... element counts
  bytes            per top-level instruction: operand+output buffer sizes
                   (fusions are costed at their boundary, like XLA does)
  collective_bytes sum of operand sizes of all-gather / all-reduce /
                   reduce-scatter / all-to-all / collective-permute,
                   multiplied through loops
"""
from __future__ import annotations

import re
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "s4": 1, "s8": 1, "u2": 1, "u4": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "token": 0, "opaque": 0, "f8e4m3fn": 1, "f8e5m2": 1,
    "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1, "e4m3": 1,
    "e5m2": 1,
}

_TRANSCENDENTAL_OPS = {
    "exponential", "exponential-minus-one", "log", "log-plus-one", "tanh",
    "rsqrt", "sqrt", "power", "sine", "cosine", "logistic", "atan2", "erf",
    "cbrt",
}

_COLLECTIVE_OPS = {
    "all-gather", "all-gather-start", "all-reduce", "all-reduce-start",
    "reduce-scatter", "all-to-all", "collective-permute",
    "collective-permute-start", "ragged-all-to-all",
}

_ZERO_COST_OPS = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "after-all", "partition-id", "replica-id", "iota", "reshape",
    "broadcast", "transpose", "convert", "copy", "copy-start", "copy-done",
    "slice", "dynamic-slice", "dynamic-update-slice", "pad", "reverse",
    "concatenate", "gather", "scatter", "rng-bit-generator",
    "rng-get-and-update-state", "opt-barrier", "custom-call", "bitcast-convert",
    "all-gather-done", "all-reduce-done", "collective-permute-done",
    "send", "send-done", "recv", "recv-done", "domain", "add-dependency",
}
# ^ zero FLOP cost; bytes still counted (data movement is their real cost)


@dataclass
class Shape:
    bytes: int
    elems: int


@dataclass
class Instr:
    name: str
    op: str
    shape: Shape
    operands: List[str]
    attrs: str
    is_root: bool = False
    raw_args: str = ""


@dataclass
class Computation:
    name: str
    instrs: List[Instr] = field(default_factory=list)
    table: Dict[str, Instr] = field(default_factory=dict)


@dataclass
class Cost:
    flops: float = 0.0
    dot_flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    wire_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)
    n_while: int = 0
    custom_calls: Dict[str, int] = field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.dot_flops += other.dot_flops * mult
        self.transcendentals += other.transcendentals * mult
        self.bytes += other.bytes * mult
        self.collective_bytes += other.collective_bytes * mult
        self.wire_bytes += other.wire_bytes * mult
        for k, v in other.collectives.items():
            slot = self.collectives.setdefault(k, {"count": 0, "bytes": 0.0})
            slot["count"] += v["count"] * mult
            slot["bytes"] += v["bytes"] * mult
        self.n_while += int(other.n_while * mult)
        for k, v in other.custom_calls.items():
            self.custom_calls[k] = self.custom_calls.get(k, 0) + v

    def to_dict(self):
        return {
            "flops": self.flops, "dot_flops": self.dot_flops,
            "transcendentals": self.transcendentals, "bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "wire_bytes": self.wire_bytes,
            "collectives": self.collectives, "n_while": self.n_while,
            "custom_calls": self.custom_calls,
        }


# ---------------------------------------------------------------------------
# type parsing


def _skip_ws_comments(s: str, pos: int) -> int:
    while pos < len(s):
        if s[pos] == " ":
            pos += 1
        elif s.startswith("/*", pos):
            end = s.find("*/", pos)
            pos = len(s) if end < 0 else end + 2
        else:
            break
    return pos


def _parse_type(s: str, pos: int = 0) -> Tuple[Shape, int]:
    """Parse a type at s[pos:]; returns (Shape, next position)."""
    if s[pos] == "(":
        total, elems = 0, 0
        pos += 1
        while pos < len(s) and s[pos] != ")":
            sh, new_pos = _parse_type(s, pos)
            total += sh.bytes
            elems += sh.elems
            pos = new_pos if new_pos > pos else pos + 1  # always progress
            pos = _skip_ws_comments(s, pos)
            if pos < len(s) and s[pos] == ",":
                pos = _skip_ws_comments(s, pos + 1)
        return Shape(total, elems), min(pos + 1, len(s))
    m = re.match(r"([a-z0-9]+)\[([0-9,]*)\]", s[pos:])
    if not m:
        return Shape(0, 0), pos  # token / unknown
    dtype, dims = m.group(1), m.group(2)
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    nbytes = _DTYPE_BYTES.get(dtype, 4) * n
    pos += m.end()
    if pos < len(s) and s[pos] == "{":  # layout
        depth = 0
        while pos < len(s):
            if s[pos] == "{":
                depth += 1
            elif s[pos] == "}":
                depth -= 1
                if depth == 0:
                    pos += 1
                    break
            pos += 1
    return Shape(nbytes, n), pos


_INSTR_RE = re.compile(
    r"^\s*(ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+)$")
_COMP_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\((.*)\)\s*->\s*.*\{\s*$")


# ---------------------------------------------------------------------------
# costing


def _attr_ref(attrs: str, key: str) -> Optional[str]:
    m = re.search(key + r"=%?([\w.\-]+)", attrs)
    return m.group(1) if m else None


def analyze_hlo(text: str) -> Dict:
    """Top-level entry: returns the unsampled cost dictionary."""
    comps, entry, dims_table, const_table = _parse_full(text)
    cache: Dict[str, Cost] = {}

    def comp_cost(name: str) -> Cost:
        if name in cache:
            return cache[name]
        comp = comps[name]
        total = Cost()
        for ins in comp.instrs:
            total.add(_instr_cost(ins, comp, comp_cost))
        cache[name] = total
        return total

    def _instr_cost(ins: Instr, comp: Computation, rec) -> Cost:
        c = Cost()
        op = ins.op
        out_b = ins.shape.bytes
        out_e = ins.shape.elems
        opnd_b = sum(comp.table[o].shape.bytes for o in ins.operands
                     if o in comp.table)
        if op in ("parameter", "constant", "get-tuple-element", "tuple",
                  "bitcast", "after-all", "reshape"):
            return c
        # ---- data-movement model --------------------------------------
        # slicing ops touch only the slice, not the full (possibly stacked-
        # over-layers) operand; counting full operands inside a while body
        # would multiply by the trip count and overstate HBM traffic by L^2.
        if op in ("dynamic-slice", "slice", "gather"):
            c.bytes = 2.0 * out_b
            return c
        if op in ("dynamic-update-slice", "scatter"):
            upd = (comp.table[ins.operands[1]].shape.bytes
                   if len(ins.operands) > 1 and ins.operands[1] in comp.table
                   else out_b)
            c.bytes = 2.0 * upd
            return c
        c.bytes = out_b + opnd_b
        if op == "while":
            body = _attr_ref(ins.attrs, "body")
            cond = _attr_ref(ins.attrs, "condition")
            trip = const_table.get(cond, 1)
            inner = Cost()
            if body in comps:
                inner.add(rec(body))
            if cond in comps:
                inner.add(rec(cond))
            c.bytes = 0.0  # carry traffic belongs to producers + body ops
            c.add(inner, mult=max(trip, 1))
            c.n_while += 1
            return c
        if op == "conditional":
            branches = re.findall(r"(?:true_computation|false_computation|"
                                  r"branch_computations=\{)([^,}]+)",
                                  ins.attrs)
            sub = [rec(b.strip("% ")) for b in branches if b.strip("% ")
                   in comps]
            if sub:
                worst = max(sub, key=lambda s: s.flops)
                c.add(worst)
            return c
        if op in ("fusion", "call", "async-start"):
            target = _attr_ref(ins.attrs, "calls") or _attr_ref(ins.attrs,
                                                                "to_apply")
            if target in comps:
                inner = rec(target)
                # fusion: inner flops count, inner BYTES don't (VMEM-resident)
                c.flops += inner.flops
                c.dot_flops += inner.dot_flops
                c.transcendentals += inner.transcendentals
                c.collective_bytes += inner.collective_bytes
                for k, v in inner.collectives.items():
                    slot = c.collectives.setdefault(
                        k, {"count": 0, "bytes": 0.0})
                    slot["count"] += v["count"]
                    slot["bytes"] += v["bytes"]
                # boundary bytes, slice-aware: a parameter whose only uses
                # inside the fusion are (dynamic-)slice/gather contributes the
                # slice size, not the full (often stacked-over-layers) operand
                c.bytes = _fusion_boundary_bytes(ins, comp, comps[target])
            return c
        if op in _COLLECTIVE_OPS:
            key = op.replace("-start", "")
            slot = c.collectives.setdefault(key, {"count": 0, "bytes": 0.0})
            slot["count"] += 1
            slot["bytes"] += opnd_b
            c.collective_bytes += opnd_b
            # ring-model wire bytes per device (used for the ICI roofline
            # term; the raw operand sum above is the assignment's metric)
            n = _group_size(ins.attrs)
            f = (n - 1) / n if n > 1 else 0.0
            if key == "all-reduce":
                c.wire_bytes += 2.0 * f * opnd_b
            elif key == "all-gather":
                c.wire_bytes += f * out_b
            elif key in ("reduce-scatter", "all-to-all",
                         "ragged-all-to-all"):
                c.wire_bytes += f * opnd_b
            else:  # collective-permute
                c.wire_bytes += opnd_b
            return c
        if op == "custom-call":
            m = re.search(r'custom_call_target="([^"]+)"', ins.attrs)
            tgt = m.group(1) if m else "?"
            c.custom_calls[tgt] = c.custom_calls.get(tgt, 0) + 1
            return c
        if op == "dot":
            k = 1
            m = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", ins.attrs)
            ldims = dims_table.get((comp.name, ins.operands[0])) if \
                ins.operands else None
            if m and m.group(1) and ldims:
                for d in m.group(1).split(","):
                    if int(d) < len(ldims):
                        k *= ldims[int(d)]
            f = 2.0 * out_e * max(k, 1)
            c.flops += f
            c.dot_flops += f
            return c
        if op == "convolution":
            k = 1
            mw = re.search(r"window=\{size=([0-9x]+)", ins.attrs)
            if mw:
                for d in mw.group(1).split("x"):
                    k *= int(d)
            cin = 1
            md = re.search(r"dim_labels=([\w?]+)_([\w?]+)->", ins.attrs)
            if md and len(ins.operands) > 1:
                rdims = dims_table.get((comp.name, ins.operands[1]))
                i_pos = md.group(2).find("i")
                if rdims and 0 <= i_pos < len(rdims):
                    cin = rdims[i_pos]
            f = 2.0 * out_e * k * cin
            c.flops += f
            c.dot_flops += f
            return c
        if op in ("reduce", "reduce-window"):
            c.flops += sum(dims_and_elems(comp, o)
                           for o in ins.operands[:1]) or out_e
            return c
        if op == "sort":
            import math
            n = max(out_e, 2)
            c.flops += n * math.log2(n)
            return c
        if op in _ZERO_COST_OPS:
            return c
        # default: elementwise
        c.flops += out_e
        if op in _TRANSCENDENTAL_OPS:
            c.transcendentals += out_e
        return c

    def dims_and_elems(comp, opname):
        ins = comp.table.get(opname)
        return ins.shape.elems if ins else 0

    if entry is None:
        # pick the largest computation as entry fallback
        entry = max(comps, key=lambda k: len(comps[k].instrs))
    total = comp_cost(entry)
    d = total.to_dict()
    d["entry"] = entry
    d["n_computations"] = len(comps)
    return d


# ---------------------------------------------------------------------------
# full parse (adds per-instruction dims + while-condition constants)


def _parse_full(text: str):
    comps: Dict[str, Computation] = {}
    dims_table: Dict[Tuple[str, str], Tuple[int, ...]] = {}
    comp_consts: Dict[str, int] = {}
    cur: Optional[Computation] = None
    entry: Optional[str] = None
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("//"):
            continue
        mc = _COMP_RE.match(line)
        if mc and ("=" not in line.split("(")[0]):
            cur = Computation(name=mc.group(2))
            comps[cur.name] = cur
            if mc.group(1):
                entry = cur.name
            # parameters appear in the signature for some printouts; the body
            # repeats them as instructions, which we rely on.
            continue
        if stripped == "}":
            cur = None
            continue
        if cur is None:
            continue
        mi = _INSTR_RE.match(line)
        if not mi:
            continue
        is_root = bool(mi.group(1))
        name = mi.group(2)
        rest = mi.group(3)
        shape, p = _parse_type(rest)
        # capture dims of the (first) array type for dot costing
        md = re.match(r"[a-z0-9]+\[([0-9,]*)\]", rest)
        if md is not None:
            dims = tuple(int(x) for x in md.group(1).split(",")) \
                if md.group(1) else ()
            dims_table[(cur.name, name)] = dims
        rest2 = rest[p:].strip()
        mo = re.match(r"([\w\-]+)\((.*)$", rest2)
        if not mo:
            continue
        op = mo.group(1)
        tail = mo.group(2)
        depth = 1
        arg_end = len(tail)
        for i, ch in enumerate(tail):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    arg_end = i
                    break
        args = tail[:arg_end]
        attrs = tail[arg_end + 1:]
        operands = re.findall(r"%([\w.\-]+)", args)
        if op == "constant":
            mval = re.match(r"\s*(-?\d+)\s*$", args)
            if mval and shape.elems <= 1:
                v = int(mval.group(1))
                comp_consts[cur.name] = max(comp_consts.get(cur.name, 0), v)
        ins = Instr(name=name, op=op, shape=shape, operands=operands,
                    attrs=attrs, is_root=is_root, raw_args=args)
        cur.instrs.append(ins)
        cur.table[name] = ins
    # while-condition trip counts: max int constant in the condition comp
    # (covers fused compare patterns: the limit constant stays at region level)
    const_table = comp_consts
    return comps, entry, dims_table, const_table


def _fusion_boundary_bytes(ins: Instr, comp: Computation,
                           fused: Computation) -> float:
    """HBM traffic at a fusion boundary with slice-awareness."""
    _SLICE = {"dynamic-slice", "slice", "gather"}
    # map parameter index -> instruction in fused computation
    params = {}
    for fi in fused.instrs:
        if fi.op == "parameter":
            m = re.match(r"\s*(\d+)", fi.raw_args)
            if m:
                params[int(m.group(1))] = fi
    root = next((fi for fi in fused.instrs if fi.is_root), None)
    total = 0.0
    for i, opname in enumerate(ins.operands):
        opnd = comp.table.get(opname)
        if opnd is None:
            continue
        pin = params.get(i)
        if pin is None:
            total += opnd.shape.bytes
            continue
        users = [fi for fi in fused.instrs if pin.name in fi.operands]
        if users and all(u.op in _SLICE for u in users):
            total += sum(u.shape.bytes for u in users)
        elif (root is not None and root.op == "dynamic-update-slice"
              and users == [root] and root.operands
              and root.operands[0] == pin.name):
            total += 0.0  # in-place DUS target: aliased, not read
        else:
            total += opnd.shape.bytes
    if root is not None and root.op in ("dynamic-update-slice", "scatter") \
            and len(root.operands) > 1:
        upd = fused.table.get(root.operands[1])
        total += 2.0 * (upd.shape.bytes if upd else ins.shape.bytes)
    else:
        total += ins.shape.bytes
    return total


def _group_size(attrs: str) -> int:
    """Collective group size from replica_groups=[G,N]<=[...] or {{...}}."""
    m = re.search(r"replica_groups=\[\d+,(\d+)\]", attrs)
    if m:
        return int(m.group(1))
    m = re.search(r"replica_groups=\{\{([^}]*)\}", attrs)
    if m:
        return max(1, m.group(1).count(",") + 1)
    return 1


# ---------------------------------------------------------------------------
# analyze_step: a traced torch step in the same schema
#
# The step runs once under ``_Counter``, a ``TorchDispatchMode`` that sees
# every aten and c10d op the call dispatches, forward and backward, on fake
# tensors (``FakeTensorMode``: shapes and dtypes, no data, no allocation).
# Eager PyTorch does not fuse, so every op's operands and output count as
# traffic: this is what the port runs op by op, not what a fusing compiler
# would move.
#
#   dot_flops        mm / bmm / addmm / convolution ... from
#                    ``torch.utils.flop_counter``'s registry
#   flops            dot_flops, plus a pointwise op's output elements and a
#                    reduction's input elements (as the reference counts
#                    elementwise and reduce instructions); softmax 5 n
#   transcendentals  exp / log / tanh / rsqrt / sqrt / pow / sin / cos /
#                    sigmoid / erf (and their variants): output elements
#   bytes            each op's tensor operands plus its output; a view
#                    (an output that aliases an input) moves none, a gather
#                    or index moves its output twice, an indexed write
#                    (index_put_, scatter, index_add_) its values twice
#   collectives      the c10d ops: the operand's bytes, the group's size from
#                    the op's process group, wire bytes by the reference's
#                    ring model (``analyze_hlo`` above)
#
# The kernels.  ``kernels.ops.flash_attention``, ``mamba_scan`` and
# ``matmul`` are priced by the kernel's own accounting
# (``kernels.calibrate``'s ``attention_cost`` / ``mamba_cost`` /
# ``matmul_cost``, bytes at the operands' element size), recorded under
# ``custom_calls`` as the reference's Pallas calls are, and not by their
# plain versions' arithmetic: the card runs the kernel.  They are
# intercepted by swapping the three functions of ``kernels.ops`` for priced
# stand-ins while the analyzer runs (``_priced_kernels``): the models call
# them as ``ops.flash_attention(...)``, so they reach the stand-ins, and
# with the analyzer not running nothing on any path changes.  A stand-in's
# forward returns an empty output of the kernel's shape; its backward is the
# plain backward (``kernels.ref``), which is what the card runs, traced op
# by op, once for each set of shapes (a model's layers share theirs), the
# cost replayed for the others, and its gradients returned empty.  The
# scan's plain backward loops over the sequence, so it is traced at 1, 2 and
# 3 steps and unsampled to the call's length (``_sampled_scan_bwd``, the
# loop-tree unsampling of ``core.sampling`` with a term in S^2).
#
# Memory: ``argument_bytes`` the call's tensor inputs, ``output_bytes`` its
# tensor outputs, ``alias_bytes`` the outputs that share an input's
# storage (params updated in place), ``temp_bytes`` the peak of the bytes
# of the storages the call allocated that were live at once (a live-storage
# tally kept by finalizers on the fake storages).

_TRANSCENDENTAL_ATEN = {
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log2", "log10", "log1p",
    "tanh", "tanh_", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "pow", "pow_",
    "sin", "cos", "sigmoid", "sigmoid_", "erf", "silu", "silu_", "gelu",
    "softplus", "logsumexp",
}
_SOFTMAX = {"_softmax", "_log_softmax"}
_GATHER_LIKE = {"index", "index_select", "gather", "embedding"}
_SCATTER_LIKE = {"index_put_", "index_put", "scatter", "scatter_",
                 "scatter_add", "scatter_add_", "index_add", "index_add_",
                 "_index_put_impl_"}
_COLLECTIVE_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast_": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute",
}


def _tensors(x):
    """The tensors in a nest of lists, tuples and dicts; a ``DTensor`` as
    its local shard (what this rank holds and computes on)."""
    import torch
    if isinstance(x, torch.Tensor):
        local = getattr(x, "_local_tensor", None)
        return [x if local is None else local]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_of(args):
    """The size of the process group among a c10d op's arguments."""
    import torch
    pg_type = torch._C._distributed_c10d.ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject) \
                and "ProcessGroup" in str(a._type()):
            return pg_type.unbox(a).size()
    return 1


class _Counter:
    """The running totals of one ``analyze_step``."""

    def __init__(self):
        self.cost = Cost()
        self.live = 0
        self.peak = 0
        self.known: Dict[int, object] = {}
        self.n_ops = 0
        self.paused = False

    def add(self, flops=0.0, dot=0.0, trans=0.0, nbytes=0.0):
        c = self.cost
        c.flops += flops
        c.dot_flops += dot
        c.transcendentals += trans
        c.bytes += nbytes

    def know(self, t) -> bool:
        """Registers ``t``'s storage; True if the call allocated it now."""
        s = t.untyped_storage()
        ref = self.known.get(id(s))
        if ref is not None and ref() is s:
            return False
        self.known[id(s)] = weakref.ref(s)
        return True

    def allocated(self, t):
        if self.know(t):
            n = t.untyped_storage().nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t.untyped_storage(), self._free, n)

    def _free(self, n):
        self.live -= n

    def merge(self, cost: Cost, peak: float):
        """Adds a traced sub-call's cost, its temporaries live on top of
        this call's."""
        self.cost.add(cost)
        self.peak = max(self.peak, self.live + peak)

    def collective(self, name, args, kwargs):
        kind = _COLLECTIVE_KIND.get(name)
        if kind is None:
            return
        ins = _tensors(args)
        if name in ("_allgather_base_", "_reduce_scatter_base_",
                    "alltoall_base_"):
            out_b, opnd_b = _nbytes(ins[0]), _nbytes(ins[1])
        elif name in ("allgather_", "allgather_into_tensor_coalesced_",
                      "reduce_scatter_", "reduce_scatter_tensor_coalesced_",
                      "alltoall_"):
            outs, opnds = _tensors(args[0]), _tensors(args[1])
            out_b = sum(_nbytes(t) for t in outs)
            opnd_b = sum(_nbytes(t) for t in opnds)
        else:
            opnd_b = out_b = sum(_nbytes(t) for t in _tensors(args[0]))
        n = _group_of(args)
        c = self.cost
        slot = c.collectives.setdefault(kind, {"count": 0, "bytes": 0.0})
        slot["count"] += 1
        slot["bytes"] += opnd_b
        c.collective_bytes += opnd_b
        f = (n - 1) / n if n > 1 else 0.0
        if kind == "all-reduce":
            c.wire_bytes += 2.0 * f * opnd_b
        elif kind == "all-gather":
            c.wire_bytes += f * out_b
        elif kind in ("reduce-scatter", "all-to-all"):
            c.wire_bytes += f * opnd_b
        else:
            c.wire_bytes += opnd_b

    def aten(self, func, args, kwargs, out):
        import torch
        from torch.utils.flop_counter import flop_registry
        name = func._overloadpacket.__name__
        outs = _tensors(out)
        if any(t.device.type == "meta" for t in outs):
            return                                   # shapes only
        self.n_ops += 1
        for t in outs:
            self.allocated(t)
        returns = func._schema.returns
        if returns and returns[0].alias_info is not None \
                and not returns[0].alias_info.is_write:
            return                                   # a view: no traffic
        out_e = sum(t.numel() for t in outs)
        out_b = sum(_nbytes(t) for t in outs)
        ins = _tensors(args) + _tensors(kwargs)
        if name in _GATHER_LIKE:
            self.add(nbytes=2.0 * out_b)
            return
        if name in _SCATTER_LIKE:
            vals = ins[2] if name.startswith("index_put") or \
                name.startswith("_index_put") else ins[-1]
            self.add(nbytes=2.0 * _nbytes(vals))
            return
        if name.startswith("empty") or name == "new_empty" \
                or name.endswith("empty_strided"):
            return
        nbytes = sum(_nbytes(t) for t in ins) + out_b
        packet = func._overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.add(flops=f, dot=f, nbytes=nbytes)
            return
        flops = trans = 0.0
        if name in _SOFTMAX:
            flops, trans = 5.0 * out_e, float(out_e)
        elif torch.Tag.reduction in func.tags:
            flops = float(ins[0].numel()) if ins else float(out_e)
        elif torch.Tag.pointwise in func.tags:
            flops = float(out_e)
        if name in _TRANSCENDENTAL_ATEN:
            trans = float(out_e)
        self.add(flops=flops, trans=trans, nbytes=nbytes)


def _counting_mode(counter: _Counter):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if counter.paused:
                return out
            ns = func.namespace
            if ns == "c10d":
                counter.collective(func._overloadpacket.__name__, args,
                                   kwargs)
            elif ns == "aten":
                counter.aten(func, args, kwargs, out)
            return out
    return _Mode()


def _kernel_call(counter: _Counter, name: str, flops: float, nbytes: float,
                 trans: float, dot: bool):
    counter.add(flops=flops, dot=flops if dot else 0.0, trans=trans,
                nbytes=nbytes)
    calls = counter.cost.custom_calls
    calls[name] = calls.get(name, 0) + 1


def _priced_kernels(counter: _Counter):
    """A context in which ``kernels.ops``' three functions are priced
    stand-ins (see the notes above ``_TRANSCENDENTAL_ATEN``)."""
    import contextlib

    import torch

    from repro_torch.kernels import calibrate, ops, ref

    def scale(t):
        return t.element_size() / calibrate.BYTES

    bwd_costs = {}     # the plain flash backward's cost by its shapes

    class _Flash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window):
            ctx.save_for_backward(q, k, v)
            ctx.causal, ctx.window = causal, window
            B, H, S, D = q.shape
            f, b = calibrate.attention_cost(B, H, k.shape[1], S, D,
                                            causal=causal)
            live = B * H * S * S * (0.5 if causal else 1.0)
            _kernel_call(counter, "flash_attention", f, b * scale(q), live,
                         True)
            return q.new_empty(q.shape)

        @staticmethod
        def backward(ctx, dout):
            q, k, v = ctx.saved_tensors
            key = tuple((tuple(t.shape), t.dtype) for t in (q, k, v, dout)) \
                + (ctx.causal, ctx.window)
            if key not in bwd_costs:
                sub = _Counter()
                counter.paused = True
                try:
                    with _counting_mode(sub):
                        ref.flash_attention_bwd_ref(
                            q, k, v, dout, causal=ctx.causal,
                            window=ctx.window)
                finally:
                    counter.paused = False
                bwd_costs[key] = (sub.cost, sub.peak)
            counter.merge(*bwd_costs[key])
            return (*(t.new_empty(t.shape) for t in (q, k, v)), None, None)

    class _Scan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, B, C, A, D, h0, return_state):
            ctx.save_for_backward(x, dt, B, C, A, D, h0)
            ctx.return_state = return_state
            b, S, d = x.shape
            N = B.shape[-1]
            f, nb = calibrate.mamba_cost(b, S, d, N)
            _kernel_call(counter, "mamba_scan", f, nb * scale(x),
                         float(b * S * d * N), False)
            y = x.new_empty(x.shape)
            if return_state:
                return y, x.new_empty((b, d, N), dtype=torch.float32)
            return y

        @staticmethod
        def backward(ctx, dy, dh=None):
            x, dt, B, C, A, D, h0 = ctx.saved_tensors
            _sampled_scan_bwd(counter, x, dt, B, C, A, D, h0, dy,
                              dh if ctx.return_state else None)
            grads = [t.new_empty(t.shape) for t in (x, dt, B, C, A, D)]
            return (*grads, None if h0 is None else h0.new_empty(h0.shape),
                    None)

    def flash_attention(q, k, v, *, causal=True, window=0):
        return _Flash.apply(q, k, v, causal, window)

    def mamba_scan(x, dt, B, C, A, D, h0=None, return_state=False):
        return _Scan.apply(x, dt, B, C, A, D, h0, return_state)

    def matmul(a, b):
        M, K = a.shape
        f, nb = calibrate.matmul_cost(M, b.shape[1], K)
        _kernel_call(counter, "matmul", f, nb * scale(a), 0.0, True)
        return a.new_empty((M, b.shape[1]))

    @contextlib.contextmanager
    def swapped():
        saved = ops.flash_attention, ops.mamba_scan, ops.matmul
        ops.flash_attention, ops.mamba_scan, ops.matmul = \
            flash_attention, mamba_scan, matmul
        try:
            yield
        finally:
            ops.flash_attention, ops.mamba_scan, ops.matmul = saved
    return swapped()


def _sampled_scan_bwd(counter: _Counter, x, dt, B, C, A, D, h0, dy, dh):
    """The plain scan backward's cost at the call's length S, from traces
    at 1, 2 and 3 steps: a + b S + c S^2 fitted through them for each of
    the Cost's terms.  The term in S^2 is eager autograd's: each step's
    gradient of a slice of the inputs is a zero tensor of the whole
    sequence, and the S of them are summed."""
    from repro_torch.kernels import ref
    S = x.shape[1]

    def traced(n):
        sub = _Counter()
        with _counting_mode(sub):
            ref.mamba_scan_bwd_ref(x[:, :n], dt[:, :n], B[:, :n], C[:, :n],
                                   A, D, h0, dy[:, :n], dh)
        return sub
    counter.paused = True
    try:
        c1, c2, c3 = (traced(n) for n in (1, 2, 3))
    finally:
        counter.paused = False
    for key in ("flops", "dot_flops", "transcendentals", "bytes"):
        y1, y2, y3 = (getattr(c.cost, key) for c in (c1, c2, c3))
        c = (y3 - 2 * y2 + y1) / 2
        b = y2 - y1 - 3 * c
        a = y1 - b - c
        setattr(counter.cost, key,
                getattr(counter.cost, key) + a + b * S + c * S * S)


def _fake_args(mode, tree_):
    """``tree_`` with each real tensor replaced by a fake one of ``mode``."""
    import torch
    from torch._subclasses.fake_tensor import is_fake
    if isinstance(tree_, torch.Tensor):
        return tree_ if is_fake(tree_) else mode.from_tensor(tree_)
    if isinstance(tree_, (list, tuple)):
        return type(tree_)(_fake_args(mode, v) for v in tree_)
    if isinstance(tree_, dict):
        return {k: _fake_args(mode, v) for k, v in tree_.items()}
    return tree_


def analyze_step(fn, *args, **kw) -> Dict:
    """One call ``fn(*args, **kw)`` of a torch step, traced on fake tensors,
    as a cost dict in ``analyze_hlo``'s schema with a ``memory`` dict
    (``argument_bytes``, ``output_bytes``, ``temp_bytes``,
    ``alias_bytes``).  Real tensors among the arguments are replaced by
    fake ones first (nothing is computed); fake ones (the dry run's, on
    rank 0 of a fake process group) are used as they are.  ``n_while`` is
    0: eager unrolls every loop, and the loops' trips are in the counts.
    See the notes above for what is counted and how the kernels are
    priced."""
    import torch
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    ins = _tensors(args) + _tensors(kw)
    mode = detect_fake_mode(ins) or FakeTensorMode(
        allow_non_fake_inputs=True)
    counter = _Counter()
    with mode:
        args, kw = _fake_args(mode, args), _fake_args(mode, kw)
        ins = _tensors(args) + _tensors(kw)
        arg_ptrs = set()
        for t in ins:
            counter.know(t)
            arg_ptrs.add(id(t.untyped_storage()))
        with _priced_kernels(counter), _counting_mode(counter):
            out = fn(*args, **kw)
        outs = _tensors(out)
    seen, arg_b, out_b, alias_b = set(), 0, 0, 0
    for t in ins:
        s = t.untyped_storage()
        if id(s) not in seen:
            seen.add(id(s))
            arg_b += s.nbytes()
    for t in outs:
        out_b += _nbytes(t)
        if id(t.untyped_storage()) in arg_ptrs:
            alias_b += _nbytes(t)
    d = counter.cost.to_dict()
    d["entry"] = getattr(fn, "__name__", "step")
    d["n_ops"] = counter.n_ops
    d["memory"] = {"argument_bytes": arg_b, "output_bytes": out_b,
                   "temp_bytes": counter.peak, "alias_bytes": alias_b}
    return d
