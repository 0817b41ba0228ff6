"""Named ranges of the program's layers on a profiler's trace.

``span(name)`` is a ``torch.profiler.record_function`` range while a torch
profiler records, so that the range and the kernels launched inside it lie
in one trace, on one clock: a kernel is put down to the range of the host
op that launched it.  With no profiler recording it is one shared no-op
context, and a step pays one check of the profiler's state a span (a
``record_function`` range costs some 10 us of host time even with no
profiler).  ``spanned(name)`` puts a whole function in ``span(name)``.

There is no switch: the spans exist exactly while someone profiles.  Every
name is in ``NAMES``; under a profiler another name raises.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import _profiler_enabled

NAMES = (
    # the serving steps (serve.step), the whole call of each
    "repro_torch.serve.prefill",
    "repro_torch.serve.decode",
    # the model step's glue around the products (models.layers)
    "repro_torch.norm",
    "repro_torch.rope",
    # one query against the cache, float32 copies of it included
    # (models.attention.decode_attention)
    "repro_torch.attn.decode",
    # Mamba1's mixer (models.ssm.mamba1_forward) but its in/out projections
    # and its scan: the conv and its silu, x_proj and dt_proj (the two
    # small products, some 3.5% of the mixer's GEMM work at falcon_mamba_7b's
    # widths), softplus, the float32 casts and A; then the gate
    "repro_torch.ssm.coeffs",
    "repro_torch.ssm.gate",
    # the MoE layer (models.moe) and its routing, dispatch indices (the
    # dropless path's sort, counts and gather of rows), expert products,
    # and the dropless path's weighted combine
    "repro_torch.moe.layer",
    "repro_torch.moe.route",
    "repro_torch.moe.dispatch",
    "repro_torch.moe.experts",
    "repro_torch.moe.combine",
    # Mamba2's mixer, its chunked SSD and its decode step (models.ssm)
    "repro_torch.ssm.mamba2",
    "repro_torch.ssm.ssd",
    "repro_torch.ssm.mamba2_decode",
    # whisper's encoder (models.transformer); the plain chunked attention
    # (cross-attention in prefill, the plain backward's forward) and
    # cross-attention in decode (models.attention)
    "repro_torch.encoder",
    "repro_torch.attn.chunked",
    "repro_torch.attn.cross_decode",
    # the plain attention backward (kernels.ref) and the optimizer's
    # clip and update (optim.optimizers)
    "repro_torch.attn.bwd_ref",
    "repro_torch.optim.clip",
    "repro_torch.optim.adamw",
)
_KNOWN = frozenset(NAMES)
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a torch profiler
    records, else a shared no-op context."""
    if not _profiler_enabled():
        return _OFF
    if name not in _KNOWN:
        raise ValueError(f"span {name!r} is not in spans.NAMES")
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: each call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
