"""The port's encdec family (whisper_small) held against the JAX package on
the CPU: the sinusoid table, ``chunked_attention``, cross-attention in
prefill and decode, the encoder, the cache, prefill and decode through the
serving steps, the converter and the CPU launchers.

Inputs are made with numpy from a seed and handed to both packages; JAX
params are carried across with ``repro_torch.convert``.  Tolerances: the
sinusoid table is computed by the same numpy code in both and held with
``==``; ``chunked_attention`` on float32 inputs at 2e-5, the tolerance of
the reference's own test of it (``tests/test_perf_flags.py:26``: the two
sum the same float32 terms in other orders); everything in bf16 at
``BF16_TOL`` (``tests/test_torch_serve.py``: XLA rounds each elementwise op
of gelu to bf16 where torch rounds once, about one bf16 step a layer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_batch as tbatch
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve.policy import StaticBatching
from repro_torch.serve.step import (make_decode_step, make_prefill_step,
                                    prefill_inputs)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16_TOL = 2e-2
CHUNKED_TOL = 2e-5
ARCH = "whisper_small"


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16_close(out, expect):
    expect = _np(expect)
    np.testing.assert_allclose(_np(out), expect, rtol=BF16_TOL,
                               atol=BF16_TOL * np.abs(expect).max())


def _bf16(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  tree)


def _models():
    """whisper_small's SMOKE config in both packages, the reference's
    params and the port's, carried across."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    tcfg = tconfigs.get_smoke_config(ARCH)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, convert.params_from_jax(_to_numpy(jparams))


@pytest.mark.parametrize("n_ctx,d_model", [(16, 64), (1500, 768), (7, 10)])
def test_sinusoid_positions_equal_reference(n_ctx, d_model):
    out = TL.sinusoid_positions(n_ctx, d_model)
    assert out.dtype == torch.float32 and out.shape == (n_ctx, d_model)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(JL.sinusoid_positions(n_ctx,
                                                                   d_model)))


# B, H, Hkv, Sq, Skv, causal, window, q_offset, kv_valid, chunk
CHUNKED_CASES = [
    (2, 4, 4, 16, 16, True, 0, 0, None, 8),        # causal, 2 chunks
    (2, 4, 4, 16, 16, False, 0, 0, None, 8),       # no causal mask
    (1, 4, 2, 20, 20, True, 6, 0, None, 8),        # window, GQA, Skv % chunk
    (1, 4, 1, 8, 24, True, 0, 16, None, 16),       # q_offset: the last 8
    (2, 4, 2, 12, 30, False, 0, 0, 25, 16),        # kv_valid, Sq != Skv
    (2, 8, 2, 7, 45, False, 0, 0, None, 512),      # one chunk of Skv
    (1, 2, 2, 33, 33, True, -1, 0, None, 16),      # window < 0: unlimited
    (1, 6, 3, 10, 50, True, 5, 40, None, 16),      # window and q_offset, GQA
]


@pytest.mark.parametrize(
    "B,H,Hkv,Sq,Skv,causal,window,q_offset,kv_valid,chunk", CHUNKED_CASES)
def test_chunked_attention_matches_reference(B, H, Hkv, Sq, Skv, causal,
                                             window, q_offset, kv_valid,
                                             chunk):
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, H, Sq, 16), (B, Hkv, Skv, 16),
                             (B, Hkv, Skv, 16)))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_valid=kv_valid, chunk=chunk)
    out = TA.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    expect = JA.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert out.dtype == torch.float32 and out.shape == (B, H, Sq, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect),
                               rtol=CHUNKED_TOL, atol=CHUNKED_TOL)


def _xattn_setup(seed):
    jcfg = jconfigs.get_smoke_config(ARCH)
    jp = {k: leaf.value for k, leaf in
          JA.attn_init(jax.random.PRNGKey(seed), jcfg).items()}
    return jcfg, tconfigs.get_smoke_config(ARCH), jp, \
        convert.tree_from_jax(_to_numpy(jp))


@pytest.mark.parametrize("Skv", [16, 37])
def test_gqa_forward_cross_matches_jax(Skv):
    """Cross-attention in prefill: queries from x (9 positions), keys and
    values from xa (``Skv`` positions, 37 off the chunk), no RoPE and no
    causal mask; the returned (k, v) are xa's, for the cache."""
    jcfg, tcfg, jp, tp = _xattn_setup(2)
    rng = np.random.default_rng(2)
    jx, tx = _bf16(rng, 2, 9, jcfg.d_model)
    jxa, txa = _bf16(rng, 2, Skv, jcfg.d_model)
    jout, (jk, jv) = JA.gqa_forward(jp, jx, None, None, cfg=jcfg,
                                    causal=False, xa=jxa)
    tout, (tk, tv) = TA.gqa_forward(tp, tx, None, None, cfg=tcfg,
                                    causal=False, xa=txa)
    assert tk.shape == (2, tcfg.n_kv_heads, Skv, tcfg.resolved_head_dim)
    _bf16_close(tout, jout)
    _bf16_close(tk, jk)
    _bf16_close(tv, jv)


def test_gqa_decode_cross_matches_jax():
    """Cross-attention in decode: one query against the encoder's (k, v);
    the self-attention caches come back untouched."""
    jcfg, tcfg, jp, tp = _xattn_setup(3)
    rng = np.random.default_rng(3)
    hd, Hkv = jcfg.resolved_head_dim, jcfg.n_kv_heads
    jx, tx = _bf16(rng, 2, 1, jcfg.d_model)
    jxk, txk = _bf16(rng, 2, Hkv, 23, hd)
    jxv, txv = _bf16(rng, 2, Hkv, 23, hd)
    ck, cv = torch.zeros(2, Hkv, 5, hd), torch.ones(2, Hkv, 5, hd)
    jout, _, _ = JA.gqa_decode(jp, jx, None, None, None, None, cfg=jcfg,
                               pos=jnp.asarray(4), xa_kv=(jxk, jxv))
    tout, ck2, cv2 = TA.gqa_decode(tp, tx, ck, cv, None, None, cfg=tcfg,
                                   pos=4, xa_kv=(txk, txv))
    assert ck2 is ck and cv2 is cv
    assert not ck.any() and bool((cv == 1).all())
    _bf16_close(tout, jout)


def test_encoder_forward_matches_jax():
    jcfg, tcfg, jparams, tparams = _models()
    frames = np.random.default_rng(4).standard_normal(
        (2, jcfg.encoder.n_ctx, jcfg.d_model)).astype(np.float32)
    out = TT._encoder_forward(tcfg, tparams, torch.from_numpy(frames))
    expect = JT._encoder_forward(jcfg, jparams, jnp.asarray(frames))
    assert out.dtype == torch.bfloat16
    assert out.shape == (2, jcfg.encoder.n_ctx, jcfg.d_model)
    _bf16_close(out, expect)


def test_embed_tokens_adds_learned_positions_exactly():
    """The decoder's token embeddings plus ``pos`` from an offset, in bf16,
    bit for bit; a start past the table is clamped as the reference's
    ``dynamic_slice`` clamps it."""
    jcfg, tcfg, jparams, tparams = _models()
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 6))
    n_pos = tparams["pos"].shape[0]
    for offset in (0, 9, n_pos - 2):
        expect = JT._embed_tokens(jcfg, jparams, jnp.asarray(tokens),
                                  pos_offset=offset)
        out = TT._embed_tokens(tcfg, tparams, torch.from_numpy(tokens),
                               offset)
        np.testing.assert_array_equal(_np(out), _np(expect))


def test_init_cache_matches_reference():
    jcfg, tcfg = jconfigs.get_smoke_config(ARCH), \
        tconfigs.get_smoke_config(ARCH)
    jcache, _ = JT.init_cache(jcfg, 3, 40)
    tcache = TT.init_cache(tcfg, 3, 40, "cpu")
    assert tcache.keys() == jcache.keys() == {"k", "v", "xk", "xv"}
    for key, t in tcache.items():
        assert (t.shape, t.dtype) == (jcache[key].shape, torch.bfloat16)
        assert not t.any()


def test_prefill_and_decode_through_serving_steps_match_jax():
    """The serving steps on the launcher's inputs (``prefill_inputs``: the
    frames as the reference's launcher makes them, 0.1 in float32), then 4
    decode steps fed the reference's greedy tokens: logits and every cache
    key (``k``, ``v``, ``xk``, ``xv``) at ``BF16_TOL``."""
    jcfg, tcfg, jparams, tparams = _models()
    B, S, n = 3, 11, 4
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab, (B, S))
    batch = prefill_inputs(tcfg, torch.from_numpy(tokens))
    assert batch["frames"].shape == (B, jcfg.encoder.n_ctx, jcfg.d_model)
    jlog, jcache = JT.prefill_forward(
        jcfg, jparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                        "frames": jnp.ones((B, jcfg.encoder.n_ctx,
                                            jcfg.d_model), jnp.float32) * .1},
        max_seq=S + n)
    tlog, tcache = make_prefill_step(tcfg, S + n)(tparams, batch)
    decode = make_decode_step(tcfg)
    _bf16_close(tlog, jlog)
    for i in range(n):
        tok = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
        jlog, jcache = JT.decode_forward(jcfg, jparams, jcache,
                                         jnp.asarray(tok, jnp.int32),
                                         jnp.asarray(S + i, jnp.int32))
        _, tcache, tlog = decode(tparams, tcache, torch.from_numpy(tok),
                                 S + i)
        _bf16_close(tlog, jlog)
    assert tcache.keys() == jcache.keys()
    for key in tcache:
        _bf16_close(tcache[key], jcache[key])


def test_converter_keeps_norm_x_float32_and_unstacks_the_encoder():
    jcfg, tcfg, jparams, tparams = _models()
    enc = tparams["encoder"]
    assert len(enc["layers"]) == jcfg.encoder.n_layers
    assert len(tparams["layers"]) == jcfg.n_layers
    assert enc["final_norm"].dtype == torch.float32
    for i, block in enumerate(tparams["layers"]):
        assert block["norm_x"].dtype == torch.float32
        assert block["xattn"]["q"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            block["norm_x"].numpy(),
            np.asarray(jparams["layers"]["norm_x"][i], np.float32))
    for i, block in enumerate(enc["layers"]):
        assert set(block) == {"norm1", "attn", "norm2", "mlp"}
        assert np.array_equal(
            block["attn"]["k"].view(torch.int16).numpy(),
            np.asarray(jparams["encoder"]["layers"]["attn"]["k"][i])
            .view(np.int16))
    assert tparams["pos"].dtype == torch.bfloat16
    assert np.array_equal(tparams["pos"].view(torch.int16).numpy(),
                          np.asarray(jparams["pos"]).view(np.int16))


def test_self_attention_prefill_goes_through_flash(monkeypatch):
    """Every self-attention of a prefill reaches ``ops.flash_attention``:
    the encoder's layers without the causal mask over the frames, the
    decoder's with it over the prompt; cross-attention never does."""
    cfg = tconfigs.get_smoke_config(ARCH)
    params = TT.init_params(cfg, seed=0, device="cpu")
    calls = []

    def flash(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"]))
        return ops_flash(q, k, v, **kw)
    ops_flash = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", flash)
    tokens = torch.randint(0, cfg.vocab, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    TT.prefill_forward(cfg, params, prefill_inputs(cfg, tokens))
    n_ctx = cfg.encoder.n_ctx
    assert calls == [(n_ctx, n_ctx, False)] * cfg.encoder.n_layers \
        + [(9, 9, True)] * cfg.n_layers


def test_flash_plain_version_refuses_kv_length_off_q():
    """q and kv of different lengths are cross-attention's shapes, which
    the flash kernel (one sequence length, as the Pallas kernel) does not
    take: its plain version refuses them on the CPU, as the CUDA wrapper
    does on the card."""
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 2, 12, 16)
    with pytest.raises(ValueError, match="length"):
        ref.flash_attention_ref(q, k, k)
    with pytest.raises(ValueError, match="length"):
        ops.flash_attention(q, k, k, causal=False)


def test_cpu_launchers_serve_whisper(capsys):
    cfg = tconfigs.get_smoke_config(ARCH)
    stats = tserve.serve(cfg, requests=3, batch=2, prompt_len=7, max_new=3,
                         device="cpu", log=lambda *a: None)
    assert stats["requests"] == 3 and stats["batches"] == 2
    assert [t.shape for t in stats["tokens"]] == [(2, 3), (1, 3)]
    assert stats["finite"]
    tserve.main(["--arch", "whisper-small", "--device", "cpu", "--requests",
                 "2", "--max-new", "2"])
    assert "served 2 requests" in capsys.readouterr().out
    out = tbatch.run_measured(cfg, StaticBatching(max_batch=2), prompt_len=5,
                              tokens=3, device="cpu", log=lambda *a: None)
    assert out["tokens"].shape == (2, 3) and out["finite"]
