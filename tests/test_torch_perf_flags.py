"""The port's perf flags (``repro_torch.dist.context.PerfFlags``) held
against the JAX package's, on the CPU.

The attention cases of ``tests/test_perf_flags.py`` (its whole-forward,
scan and MoE cases are in ``test_torch_perf_flags_models.py``) and the
flags' string normalisation run on the port, with that
file's own tolerances between a flagged run and the baseline, and beside
it the reference's flagged run on identical inputs: numpy inputs from a
seed, the reference's params carried across with ``repro_torch.convert``.
bf16 outputs are held at ``BF16_TOL`` (see ``test_torch_serve.py``),
float32 ones at the reference test's own tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import context as jctx
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.dist import context as tctx
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT

BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    jctx.set_perf_flags(jctx.PerfFlags())
    tctx.set_perf_flags(tctx.PerfFlags())


def _set_flags(**flags):
    jctx.set_perf_flags(jctx.PerfFlags(**flags))
    tctx.set_perf_flags(tctx.PerfFlags(**flags))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _assert_bf16_close(out, expect):
    expect = _np(expect)
    np.testing.assert_allclose(_np(out), expect, rtol=BF16_TOL,
                               atol=BF16_TOL * np.abs(expect).max())


def _params(arch):
    """(jax cfg, port cfg, jax params, port params) of ``arch``'s smoke
    config, the reference's params from PRNGKey(0)."""
    jcfg, tcfg = jconfigs.get_smoke_config(arch), \
        tconfigs.get_smoke_config(arch)
    jp, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, convert.params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                               jp))


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_perf_flags_fields_and_string_normalisation():
    """The six fields with the reference's defaults, and CLI strings for
    the bool fields normalised as the reference normalises them."""
    assert dataclasses.asdict(tctx.PerfFlags()) == \
        dataclasses.asdict(jctx.PerfFlags())
    for v in ("1", "true", "Yes", "ON", "0", "false", "no", "off", "x"):
        kw = {f: v for f in ("attn_remat_chunk", "windowed_attention",
                             "seq_sharded_residual", "bf16_tp_collectives")}
        t = tctx.PerfFlags(**kw, ssm_impl="chunked", moe_dispatch="einsum")
        j = jctx.PerfFlags(**kw, ssm_impl="chunked", moe_dispatch="einsum")
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.windowed_attention is (v.lower() in ("1", "true", "yes",
                                                      "on"))
    tctx.set_perf_flags(tctx.PerfFlags(windowed_attention=True))
    assert tctx.perf_flags().windowed_attention


def test_windowed_matches_masked_chunked():
    B, H, Hkv, S, D, w = 1, 4, 2, 256, 16, 32
    q, k, v = (_normal(i, B, h, S, D) for i, h in enumerate((H, Hkv, Hkv)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    a = TA.windowed_attention(tq, tk, tv, window=w, chunk=64)
    b = TA.chunked_attention(tq, tk, tv, causal=True, window=w, chunk=64)
    np.testing.assert_allclose(_np(a), _np(b), atol=2e-5)
    expect = JA.windowed_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=w, chunk=64)
    np.testing.assert_allclose(_np(a), _np(expect), atol=2e-5)
    with pytest.raises(AssertionError):
        TA.windowed_attention(tq, tk, tv, window=128, chunk=64)


def test_attn_remat_chunk_same_grads():
    B, H, S, D = 1, 2, 128, 16
    q, k, v = (_normal(i, B, H, S, D) for i in range(3))
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)

    def grad():
        tq = torch.from_numpy(q).requires_grad_()
        out = TA.chunked_attention(tq, tk, tv, causal=True, chunk=32)
        return torch.autograd.grad((out ** 2).sum(), tq)[0]

    g_base = grad()
    tctx.set_perf_flags(tctx.PerfFlags(attn_remat_chunk=True))
    g_remat = grad()
    np.testing.assert_allclose(_np(g_base), _np(g_remat), atol=1e-5)
    expect = jax.grad(lambda q: jnp.sum(JA.chunked_attention(
        q, jnp.asarray(k), jnp.asarray(v), causal=True, chunk=32) ** 2))(
            jnp.asarray(q))
    np.testing.assert_allclose(_np(g_remat), _np(expect), atol=1e-5)


def test_windowed_prefill_cache_compatible():
    """The windowed prefill fills a cache the decode path continues from,
    matching the baseline prefill; each step also matches the reference's
    flagged run at ``BF16_TOL``."""
    jcfg, tcfg, jp, tp = _params("gemma3_1b")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 9))
    t8, t1 = torch.from_numpy(toks[:, :8]), torch.from_numpy(toks[:, 8:9])
    ref, cache_ref = TT.prefill_forward(tcfg, tp, {"tokens": t8}, max_seq=12)
    _set_flags(windowed_attention=True, attn_remat_chunk=True)
    opt, cache_opt = TT.prefill_forward(tcfg, tp, {"tokens": t8}, max_seq=12)
    jopt, jcache = JT.prefill_forward(
        jcfg, jp, {"tokens": jnp.asarray(toks[:, :8], jnp.int32)},
        max_seq=12)
    _set_flags()
    np.testing.assert_allclose(_np(ref), _np(opt), atol=0.05)
    _assert_bf16_close(opt, jopt)
    for key in cache_opt:
        _assert_bf16_close(cache_opt[key], jcache[key])
    ld_ref, _ = TT.decode_forward(tcfg, tp, cache_ref, t1, 8)
    ld_opt, _ = TT.decode_forward(tcfg, tp, cache_opt, t1, 8)
    np.testing.assert_allclose(_np(ld_ref), _np(ld_opt), atol=0.05)
    jld, _ = JT.decode_forward(jcfg, jp, jcache,
                               jnp.asarray(toks[:, 8:9], jnp.int32), 8)
    _assert_bf16_close(ld_opt, jld)


def test_windowed_decode_matches_baseline():
    """Sliced-cache decode (static_window) == full-cache masked decode, two
    steps on; and each flagged step against the reference's."""
    jcfg, tcfg, jp, tp = _params("gemma3_1b")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 12))
    t = torch.from_numpy(toks)
    jt = jnp.asarray(toks, jnp.int32)
    _, cache = TT.prefill_forward(tcfg, tp, {"tokens": t[:, :10]},
                                  max_seq=16)
    _, jcache = JT.prefill_forward(jcfg, jp, {"tokens": jt[:, :10]},
                                   max_seq=16)
    base = {k: v.clone() for k, v in cache.items()}
    ref, cache_ref = TT.decode_forward(tcfg, tp, base, t[:, 10:11], 10)
    _set_flags(windowed_attention=True)
    opt, cache_opt = TT.decode_forward(tcfg, tp, cache, t[:, 10:11], 10)
    step2_opt, _ = TT.decode_forward(tcfg, tp, cache_opt, t[:, 11:12], 11)
    jopt, jcache = JT.decode_forward(jcfg, jp, jcache, jt[:, 10:11], 10)
    jstep2, _ = JT.decode_forward(jcfg, jp, jcache, jt[:, 11:12], 11)
    _set_flags()
    step2_ref, _ = TT.decode_forward(tcfg, tp, cache_ref, t[:, 11:12], 11)
    np.testing.assert_allclose(_np(ref), _np(opt), atol=0.05)
    np.testing.assert_allclose(_np(step2_ref), _np(step2_opt), atol=0.05)
    _assert_bf16_close(opt, jopt)
    _assert_bf16_close(step2_opt, jstep2)


@pytest.mark.parametrize("pos", [0, 3, 7, 15])
def test_static_window_decode_slices_the_cache(pos):
    """gqa_decode's static window reads the window's slice of the cache,
    clamped into it at the start and the end: equal to the masked full
    cache at every position, and to the reference's slice."""
    jcfg = jconfigs.get_smoke_config("gemma3_1b")
    tcfg = tconfigs.get_smoke_config("gemma3_1b")
    jp = {k: leaf.value for k, leaf in
          JA.attn_init(jax.random.PRNGKey(3), jcfg).items()}
    tp = convert.tree_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp))
    B, S, hd, Hkv = 2, 16, jcfg.resolved_head_dim, jcfg.n_kv_heads
    x, ck, cv = _normal(4, B, 1, jcfg.d_model), _normal(5, B, Hkv, S, hd), \
        _normal(6, B, Hkv, S, hd)
    jcos, jsin = JT._rope_for(jcfg, jnp.full((1,), pos))
    tcos, tsin = TT._rope_for(tcfg, torch.full((1,), pos))

    def port(**kw):
        return TA.gqa_decode(tp, torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(ck).bfloat16(),
                             torch.from_numpy(cv).bfloat16(), tcos, tsin,
                             cfg=tcfg, pos=pos, **kw)[0]
    sliced = port(static_window=jcfg.window)
    np.testing.assert_array_equal(_np(sliced), _np(port(window=jcfg.window)))
    expect = JA.gqa_decode(jp, jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(ck, jnp.bfloat16),
                           jnp.asarray(cv, jnp.bfloat16), jcos, jsin,
                           cfg=jcfg, pos=pos, static_window=jcfg.window)[0]
    _assert_bf16_close(sliced, expect)
