"""The port's vlm family (internvl2_26b) held against the JAX package on the
CPU: the patch prefix, GQA prefill at the full config's head dim, the cache
positions the patches take, prefill and decode through the serving steps
with decode after the patches, and the CPU launchers.

Inputs are made with numpy from a seed and handed to both packages; JAX
params are carried across with ``repro_torch.convert``.  The input
embeddings (bf16 patches ahead of bf16 token embeddings) are held with
``==``; everything after them at ``BF16_TOL`` (``tests/test_torch_serve.py``:
matmuls sum in other orders and XLA rounds each elementwise op of silu to
bf16 where torch rounds once, about one bf16 step a layer).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_batch as tbatch
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serve.policy import StaticBatching
from repro_torch.serve.step import (make_decode_step, make_prefill_step,
                                    prefill_inputs, prompt_positions)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16_TOL = 2e-2
ARCH = "internvl2_26b"


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _bf16_close(out, expect):
    expect = _np(expect)
    np.testing.assert_allclose(_np(out), expect, rtol=BF16_TOL,
                               atol=BF16_TOL * np.abs(expect).max())


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  tree)


def _models():
    jcfg = jconfigs.get_smoke_config(ARCH)
    tcfg = tconfigs.get_smoke_config(ARCH)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, convert.params_from_jax(_to_numpy(jparams))


def test_full_config_heads_take_the_flash_kernel():
    """internvl2_26b's prefill attention runs at head dim 128 with 48
    query heads on 8 KV heads, whisper_small's at 64 with 12 on 12: head
    dims of the flash kernel (no new instance is needed)."""
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads) == \
        (128, 48, 8)
    w = tconfigs.get_config("whisper_small")
    assert (w.resolved_head_dim, w.n_heads, w.n_kv_heads) == (64, 12, 12)
    assert {cfg.resolved_head_dim, w.resolved_head_dim} <= set(fa.HEAD_DIMS)


def test_prepare_inputs_puts_the_patches_first_exactly():
    jcfg, tcfg, jparams, tparams = _models()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (2, 7))
    patches = rng.standard_normal((2, jcfg.n_patches, jcfg.d_model),
                                  np.float32)
    (jx, jxa) = JT._prepare_inputs(jcfg, jparams, {
        "tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)})
    tx, txa = TT._prepare_inputs(tcfg, tparams, {
        "tokens": torch.from_numpy(tokens),
        "patches": torch.from_numpy(patches)})
    assert jxa is None and txa is None
    assert tx.dtype == torch.bfloat16
    assert tx.shape == (2, jcfg.n_patches + 7, jcfg.d_model)
    np.testing.assert_array_equal(_np(tx), _np(jx))


@pytest.mark.parametrize("head_dim", [0, 128])
def test_gqa_forward_over_patches_and_tokens_matches_jax(head_dim):
    """GQA prefill (8 query heads on 2) over a patch prefix and tokens, at
    the SMOKE head dim (8) and at the FULL config's (128), RoPE at the
    FULL config's theta (1e6)."""
    jcfg, tcfg = (dataclasses.replace(
        mod.get_smoke_config(ARCH), head_dim=head_dim,
        rope_theta=tconfigs.get_config(ARCH).rope_theta)
        for mod in (jconfigs, tconfigs))
    jp = {k: leaf.value for k, leaf in
          JA.attn_init(jax.random.PRNGKey(1), jcfg).items()}
    tp = convert.tree_from_jax(_to_numpy(jp))
    S = jcfg.n_patches + 13
    a = np.random.default_rng(1).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(a).astype(jnp.bfloat16)
    tx = torch.from_numpy(a).bfloat16()
    jcos, jsin = JT._rope_for(jcfg, jnp.arange(S))
    tcos, tsin = TT._rope_for(tcfg, torch.arange(S))
    jout, (jk, jv) = JA.gqa_forward(jp, jx, jcos, jsin, cfg=jcfg)
    tout, (tk, tv) = TA.gqa_forward(tp, tx, tcos, tsin, cfg=tcfg)
    _bf16_close(tout, jout)
    _bf16_close(tk, jk)
    _bf16_close(tv, jv)


def test_prefill_and_decode_through_serving_steps_match_jax():
    """The serving steps on the launcher's inputs (``prefill_inputs``: the
    patches as the reference's launcher makes them, 0.1 in float32), then
    4 decode steps at the positions after the patches and the prompt, fed
    the reference's greedy tokens: logits and the cache at ``BF16_TOL``.
    The patches fill cache positions [0, n_patches); the positions past
    the last decode step stay 0."""
    jcfg, tcfg, jparams, tparams = _models()
    B, S, n = 3, 10, 4
    start = prompt_positions(tcfg, S)
    assert start == jcfg.n_patches + S
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (B, S))
    batch = prefill_inputs(tcfg, torch.from_numpy(tokens))
    assert batch["patches"].shape == (B, jcfg.n_patches, jcfg.d_model)
    jlog, jcache = JT.prefill_forward(
        jcfg, jparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                        "patches": jnp.ones((B, jcfg.n_patches, jcfg.d_model),
                                            jnp.float32) * .1},
        max_seq=start + n + 2)
    tlog, tcache = make_prefill_step(tcfg, start + n + 2)(tparams, batch)
    assert tcache["k"].shape == jcache["k"].shape
    assert tcache["k"][:, :, :, :jcfg.n_patches].any()
    _bf16_close(tlog, jlog)
    for key in tcache:
        _bf16_close(tcache[key], jcache[key])
    decode = make_decode_step(tcfg)
    for i in range(n):
        tok = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
        jlog, jcache = JT.decode_forward(jcfg, jparams, jcache,
                                         jnp.asarray(tok, jnp.int32),
                                         jnp.asarray(start + i, jnp.int32))
        _, tcache, tlog = decode(tparams, tcache, torch.from_numpy(tok),
                                 start + i)
        _bf16_close(tlog, jlog)
    for key in tcache:
        _bf16_close(tcache[key], jcache[key])
        assert not tcache[key][:, :, :, start + n:].any()


def test_self_attention_prefill_goes_through_flash(monkeypatch):
    """Each layer's prefill attention reaches ``ops.flash_attention`` once,
    causal, over the patches and the prompt together."""
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
    S = cfg.n_patches + 9
    assert calls == [(S, S, True)] * cfg.n_layers


def test_cpu_launchers_serve_internvl2(capsys):
    cfg = tconfigs.get_smoke_config(ARCH)
    stats = tserve.serve(cfg, requests=3, batch=2, prompt_len=6, max_new=3,
                         device="cpu", log=lambda *a: None)
    assert stats["requests"] == 3 and stats["batches"] == 2
    assert [t.shape for t in stats["tokens"]] == [(2, 3), (1, 3)]
    assert stats["finite"]
    tserve.main(["--arch", "internvl2-26b", "--device", "cpu", "--requests",
                 "2", "--max-new", "2"])
    assert "served 2 requests" in capsys.readouterr().out
    out = tbatch.run_measured(cfg, StaticBatching(max_batch=2), prompt_len=5,
                              tokens=3, device="cpu", log=lambda *a: None)
    assert out["tokens"].shape == (2, 3) and out["finite"]
