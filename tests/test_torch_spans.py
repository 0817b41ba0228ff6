"""The program's spans (``repro_torch.core.spans``), on the CPU.

With no profiler a span is one shared no-op context and never builds a
``record_function``; under ``torch.profiler`` the serving steps of each
family's SMOKE config record the spans of the layers they run, nested as
the calls nest, each name one of ``spans.NAMES``; and a step computes the
same bits with the profiler on and off.
"""
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.core import spans
from repro_torch.kernels import ref
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.serve.step import (greedy, make_decode_step,
                                    make_prefill_step, prefill_inputs,
                                    prompt_positions)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve(arch, steps=1):
    """One prefill of 2 prompts of 16 tokens and ``steps`` greedy decode
    steps of ``arch``'s SMOKE config on the CPU: (prefill logits, [decode
    logits], cache)."""
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, 0, "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    start = prompt_positions(cfg, 16)
    logits, cache = make_prefill_step(cfg, start + steps)(
        params, prefill_inputs(cfg, tokens))
    decode, tok, out = make_decode_step(cfg), greedy(logits), []
    for i in range(steps):
        tok, cache, step_logits = decode(params, cache, tok, start + i)
        out.append(step_logits)
    return logits, out, cache


def _recorded(prof):
    """[(name, start, end)] of the program's spans in ``prof``'s trace."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name().startswith("repro_torch.")]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _recorded(prof)


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert spans.span("repro_torch.norm") is spans.span("repro_torch.rope")
    assert isinstance(spans.span("repro_torch.norm"),
                      contextlib.nullcontext)
    _serve("phi3_mini_3_8b")


def test_an_unknown_name_raises_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="NAMES"):
            spans.span("repro_torch.no_such_layer")


@pytest.mark.parametrize("arch,names", [
    ("phi3_mini_3_8b", {"repro_torch.serve.prefill",
                        "repro_torch.serve.decode", "repro_torch.norm",
                        "repro_torch.rope", "repro_torch.attn.decode"}),
    ("falcon_mamba_7b", {"repro_torch.serve.prefill",
                         "repro_torch.serve.decode", "repro_torch.norm",
                         "repro_torch.ssm.coeffs", "repro_torch.ssm.gate"}),
    ("granite_moe_1b_a400m", {"repro_torch.moe.layer", "repro_torch.moe.route",
                              "repro_torch.moe.dispatch",
                              "repro_torch.moe.experts"}),
    ("zamba2_2_7b", {"repro_torch.ssm.mamba2", "repro_torch.ssm.ssd",
                     "repro_torch.ssm.mamba2_decode"}),
    ("whisper_small", {"repro_torch.encoder", "repro_torch.attn.chunked",
                       "repro_torch.attn.cross_decode"}),
])
def test_serving_records_the_spans_of_its_layers(arch, names):
    _, got = _profiled(lambda: _serve(arch))
    assert names <= {s[0] for s in got}
    assert {s[0] for s in got} <= set(spans.NAMES)
    steps = [s for s in got if s[0] == "repro_torch.serve.decode"]
    assert len(steps) == 1
    # every span but the steps' own lies inside one of the two steps
    top = [s for s in got if s[0].startswith("repro_torch.serve.")]
    assert len(top) == 2
    for s in got:
        assert any(_inside(s, t) for t in top), s
    for s in got:
        if s[0] in ("repro_torch.attn.decode", "repro_torch.ssm.mamba2_decode",
                    "repro_torch.attn.cross_decode"):
            assert _inside(s, steps[0]), s


@pytest.mark.parametrize("arch", ["phi3_mini_3_8b", "falcon_mamba_7b"])
def test_a_step_is_bitwise_the_same_under_the_profiler(arch):
    off = _serve(arch, steps=2)
    on, _ = _profiled(lambda: _serve(arch, steps=2))
    assert torch.equal(off[0], on[0])
    assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))
    assert off[2].keys() == on[2].keys()
    for k in off[2]:
        assert all(torch.equal(a, b) for a, b in zip(off[2][k], on[2][k])), k


def test_training_stages_record_their_spans():
    g = torch.Generator().manual_seed(2)
    q, k, v, dout = (torch.randn(1, 2, 8, 16, generator=g) for _ in range(4))
    params = [torch.randn(4, 4, generator=g)]

    def stages():
        ref.flash_attention_bwd_ref(q, k, v, dout)
        grads, _ = clip_by_global_norm([torch.ones(4, 4)], 1.0)
        adamw_update(grads, adamw_init(params), params, lr=1e-3)
    _, got = _profiled(stages)
    names = [s[0] for s in got]
    assert {"repro_torch.attn.bwd_ref", "repro_torch.attn.chunked",
            "repro_torch.optim.clip", "repro_torch.optim.adamw"} == set(names)
    bwd = next(s for s in got if s[0] == "repro_torch.attn.bwd_ref")
    assert all(_inside(s, bwd) for s in got
               if s[0] == "repro_torch.attn.chunked")
