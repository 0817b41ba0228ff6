"""DeepSeek-V2-Lite as published, on the port's serving path, held against
the benchmark's plain reference (``bench/reference/mla_moe.py``, imported
by path) at a small size on the CPU: dropless top-k routing with gates
that are not renormalised, and YaRN rope with its softmax factor.

Weights are the port's seeded init.  The MoE layer runs on float32 hidden
states and float32 weights, where the port and the reference compute the
same float32 products and differ only in summation order, a few 1e-6 of
the outputs' scale: held at ``TOL``, 1e-5 of it.  The whole model serves
in bf16 as the port always does (its embeddings and its cache are bf16),
against the float32 reference on the same bf16 weights: held at
``LOGITS_STD`` and ``CACHE_REL``, about 2.5x what bf16 reads here (0.11
and 0.016) and under what a renormalised gate (1.08, 0.15), one dropped
assignment (0.76, 0.07) or a missing softmax factor (2.6, 0.37) reads.
Routing is discontinuous; the seeds here hold no near tie.
"""
import dataclasses
import importlib
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.config import (MLAConfig, ModelConfig, MoEConfig,
                                     YarnConfig)
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.layers import (rope_tables, yarn_mscale,
                                       yarn_softmax_factor)
from repro_torch.serve import step as serve_step

BENCH = Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))
REF = importlib.import_module("reference.mla_moe")
Precision = importlib.import_module("reference.common").Precision

# summation order in float32, over the outputs' largest size
TOL = 1e-5
# bf16 serving against the float32 reference: the largest logit error in
# units of the reference logits' standard deviation, and the cache's
# relative L2 error (bench/yardstick/check.py's ``logits`` and ``cache``)
LOGITS_STD = 0.3
CACHE_REL = 0.04
# one bf16 rounding step (2**-8) of the logits' scale: a batch's products
# may round differently from a lone request's
BATCH_TOL = 2.0 ** -8
YARN = {"factor": 40, "original_max_position_embeddings": 4096,
        "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
        "mscale_all_dim": 0.707}
MODEL = {"name": "dsv2lite_small", "family": "moe", "n_layers": 2,
         "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 48,
         "vocab": 256, "activation": "swiglu", "rope_theta": 10_000.0,
         "moe": {"n_experts": 8, "top_k": 3, "n_shared": 1,
                 "d_ff_expert": 48, "norm_topk_prob": False,
                 "dropless": True},
         "mla": {"kv_lora_rank": 32, "q_lora_rank": 0, "qk_nope_dim": 16,
                 "qk_rope_dim": 8, "v_head_dim": 16},
         "rope_scaling": YARN}
SPEC = {"model": MODEL, "rms_norm_eps": 1e-6}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**moe):
    cfg = ModelConfig(**MODEL)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


def _params(cfg, seed=0):
    """The port's init, in float32."""
    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        if isinstance(t, list):
            return [f32(v) for v in t]
        return t.float()
    return f32(TT.init_params(cfg, seed, "cpu"))


def _tokens(B, S, seed=1):
    return torch.randint(0, MODEL["vocab"], (B, S),
                         generator=torch.Generator().manual_seed(seed))


def _close(got, want, tol=TOL):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=tol * float(want.abs().max()))


def _serve(cfg, params, tokens, n_decode, max_seq):
    """The port's serving steps: the prefill's last logits, then
    ``n_decode`` greedy steps through the cache; returns (served tokens
    (B, 1 + n_decode), logits of each (B, 1 + n_decode, V), cache)."""
    prefill = serve_step.make_prefill_step(cfg, max_seq)
    decode = serve_step.make_decode_step(cfg)
    logits, cache = prefill(params, serve_step.prefill_inputs(cfg, tokens))
    tok = serve_step.greedy(logits)
    toks, lgs = [tok], [logits[:, -1]]
    S = tokens.shape[1]
    for i in range(n_decode):
        tok, cache, logits = decode(params, cache, tok, S + i)
        toks.append(tok)
        lgs.append(logits[:, -1])
    return torch.cat(toks, 1), torch.stack(lgs, 1), cache


def test_prefill_and_decode_match_reference():
    """Prefill's logits and 4 decode steps through the cache, served in
    bf16, against the reference's full forward over the prompt and the
    fed-back tokens, and the cache's c_kv and k_rope rows at every
    position."""
    cfg, S, n = _cfg(), 24, 4
    params = TT.init_params(cfg, 0, "cpu")
    tokens = _tokens(2, S)
    served, logits, cache = _serve(cfg, params, tokens, n, S + n)
    for b in range(2):
        seq = torch.cat([tokens[b], served[b, :-1]])
        rows = {}
        ref = REF.forward(SPEC, params, seq, torch.arange(S - 1, S + n),
                          "fp32", lambda li, st: rows.update(
                              {(li, k): v for k, v in st.items()}))
        err = (logits[b].float() - ref).abs().amax(-1) / ref.std(-1)
        assert float(err.max()) < LOGITS_STD
        for (li, key), want in rows.items():
            got = cache[key][li, b, :S + n].float()
            assert float((got - want).norm() / want.norm()) < CACHE_REL


def test_dropless_matches_reference_moe_layer():
    """``moe_apply`` on the dropless path against the reference's MoE
    layer on the same float32 hidden states: every assignment, the gates
    unrenormalised, the shared expert."""
    cfg = _cfg()
    p = _params(cfg)["layers"][0]["moe"]
    x = torch.randn(2, 40, MODEL["d_model"],
                    generator=torch.Generator().manual_seed(3))
    out, _ = TM.moe_apply(p, x, cfg)
    ref = REF.moe(SPEC, p, x.reshape(80, -1), Precision("fp32"))
    _close(out.reshape(80, -1), ref)


def test_skewed_router_every_token_to_one_expert():
    """A router that makes expert 0 every token's first choice: dropless
    equals the reference; the capacity path, whose expert 0 holds
    ceil(T k 1.25 / E) of the T assignments, drops the rest and does not."""
    cfg = _cfg()
    p = dict(_params(cfg)["layers"][0]["moe"])
    d = MODEL["d_model"]
    router = p["router"].clone()
    router[:, 0] = 1.0
    p["router"] = router
    # hidden states with a common positive part: expert 0's logit ~ d
    x = 1.0 + 0.1 * torch.randn(1, 64, d,
                                generator=torch.Generator().manual_seed(4))
    _, idx, _ = TM._route(x[0], router, 8, 3, False)
    assert (idx[:, 0] == 0).all()
    ref = REF.moe(SPEC, p, x[0], Precision("fp32"))
    out, _ = TM.moe_apply(p, x, cfg)
    _close(out[0], ref)
    capped, _ = TM.moe_apply(p, x, _cfg(dropless=False))
    assert float((capped[0] - ref).abs().max()) > 0.1 * float(
        ref.abs().max())


def test_request_alone_equals_it_in_a_batch():
    """A request's logits and cache rows do not depend on its batch mates:
    alone, and second in a batch of 4, served in bf16.  The capacity path's
    drops depend on them."""
    cfg, S = _cfg(), 20
    params = TT.init_params(cfg, 0, "cpu")
    tokens = _tokens(4, S, seed=7)
    served, logits, cache = _serve(cfg, params, tokens, 2, S + 2)
    one, one_logits, one_cache = _serve(cfg, params, tokens[1:2], 2, S + 2)
    assert torch.equal(served[1:2], one)
    _close(logits[1:2].float(), one_logits.float(), BATCH_TOL)
    for key in ("ckv", "krope"):
        _close(cache[key][:, 1:2].float(), one_cache[key].float(),
               BATCH_TOL)
    capped = _cfg(dropless=False)
    _, logits, _ = _serve(capped, params, tokens, 2, S + 2)
    _, one_logits, _ = _serve(capped, params, tokens[1:2], 2, S + 2)
    assert float((logits[1:2] - one_logits).float().abs().max()) > 0.1 * \
        float(one_logits.float().abs().max())


def test_yarn_tables_against_closed_form():
    """DeepSeek-V2-Lite's YaRN at dim 64, theta 1e4: the correction range
    is [10, 23]; frequencies below 10 kept, from 23 on divided by 40, a
    linear blend between; the tables unscaled (mscale = mscale_all_dim);
    the softmax factor (0.1 x 0.707 ln 40 + 1)**2 = 1.589626."""
    ys = YarnConfig(**YARN)
    dim, theta = 64, 1e4
    pos = torch.arange(0, 4096, 7)
    cos, sin = rope_tables(pos, dim, theta, ys)
    i = torch.arange(dim // 2, dtype=torch.float64)
    plain = theta ** (-2 * i / dim)
    ramp = ((i - 10) / 13).clamp(0, 1)
    inv = plain / 40 * ramp + plain * (1 - ramp)
    assert (ramp[:11] == 0).all() and (ramp[23:] == 1).all()
    ang = pos.double()[:, None] * inv
    # float32 angles: |pos x inv| ulp at 4095 rad
    assert torch.allclose(cos.double(), torch.cos(ang), atol=1e-3)
    assert torch.allclose(sin.double(), torch.sin(ang), atol=1e-3)
    assert yarn_mscale(40, 0.707) == pytest.approx(1.2608038, abs=1e-7)
    assert yarn_softmax_factor(ys) == pytest.approx(1.589626, abs=1e-6)
    assert yarn_softmax_factor(None) == 1.0
    # the reference works them out on its own
    r_inv, r_table, r_soft = REF.rope_scaling(
        {"model": {"mla": {"qk_rope_dim": dim}, "rope_theta": theta,
                   "rope_scaling": YARN}})
    assert torch.allclose(r_inv, inv, rtol=1e-12)
    assert r_table == pytest.approx(1.0) and \
        r_soft == pytest.approx(1.589626, abs=1e-6)


def test_model_config_from_dicts():
    """Sub-configs given as dicts (a JSON file's) become their dataclasses;
    an unknown key raises; the defaults keep the JAX package's MoE."""
    cfg = ModelConfig(**MODEL)
    assert cfg.moe == MoEConfig(n_experts=8, top_k=3, n_shared=1,
                                d_ff_expert=48, norm_topk_prob=False,
                                dropless=True)
    assert cfg.mla == MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                                qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    assert cfg.rope_scaling == YarnConfig(**YARN)
    assert hash(cfg) == hash(dataclasses.replace(cfg))
    assert MoEConfig().norm_topk_prob and not MoEConfig().dropless
    for key in ("moe", "mla", "rope_scaling"):
        with pytest.raises(TypeError, match="unknown"):
            ModelConfig(**{**MODEL, key: {**MODEL[key], "nope": 1}})
