"""The port's Mamba2 mixer (``repro_torch.models.ssm``), the hybrid family
(zamba2_2_7b) and the ssm family at version 2, held against the JAX package
on the CPU.

Inputs are made with numpy from a seed and handed to both packages, at
zamba2_2_7b's SMOKE size (d_model 64, d_inner 128, 8 heads of head dim 16,
N 16, chunk 32).  Prompts are one chunk, three chunks or shorter than a
chunk: the reference asserts S % min(chunk, S) == 0, and so does the port.

Tolerances.  In float32 (params and input float32) the two packages differ
by the order of their sums and their exp and softplus: 2e-4 (rtol, and atol
as a share of max(|expect|, 1)), the scan's float32 tolerance
(``tests/test_kernels.py``), holds the output and the final state h_T
(float32 in both); the conv tail is bf16 in both packages, so float32
inputs a summation order apart may round to neighbouring bf16 values, and
it is held at ``BF16_TOL`` in both types.  In bf16, as the model runs,
matmuls sum in other orders and values differ by about one bf16 step a
layer: ``BF16_TOL`` (2e-2 relative, plus 2e-2 of the largest magnitude),
as in ``tests/test_torch_serve.py``; the float32 state h_T is held at the
same ``BF16_TOL``, since its inputs (x, B, C after the bf16 conv) carry
those steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16_TOL = 2e-2
F32_TOL = 2e-4
ARCH = "zamba2_2_7b"


def _cfgs(**over):
    """zamba2_2_7b's SMOKE config in both packages, with ``over`` replaced."""
    return [dataclasses.replace(mod.get_smoke_config(ARCH), **over)
            for mod in (jconfigs, tconfigs)]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _close(out, expect, tol):
    expect = _np(expect)
    np.testing.assert_allclose(_np(out), expect, rtol=tol,
                               atol=tol * max(np.abs(expect).max(), 1.0))


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  tree)


def _mixer_params(jcfg, dtype, seed=0, **f32):
    """The reference's Mamba2 params and the port's copy of them; in
    float32, every leaf float32 in both.  ``f32`` replaces float32 leaves
    (``A_log``, ``dt_bias``) in both."""
    jp = {k: leaf.value for k, leaf in
          JS.mamba2_init(jax.random.PRNGKey(seed), jcfg).items()}
    jp.update({k: jnp.asarray(v, jnp.float32) for k, v in f32.items()})
    if dtype == "float32":
        jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
        return jp, {k: torch.from_numpy(_np(v)) for k, v in jp.items()}
    return jp, convert.tree_from_jax(_to_numpy(jp))


def _both(rng, dtype, *shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _state(rng, cfg, B):
    s = cfg.ssm
    h0 = rng.standard_normal((B, s.n_heads, s.head_dim, s.d_state)) \
        .astype(np.float32)
    return {"ssm": jnp.asarray(h0)}, {"ssm": torch.from_numpy(h0)}


# ---------------------------------------------------------------------------
# the mixer


def test_mamba2_init_matches_reference_tree():
    """The port's own init has the reference's keys, shapes and dtypes (the
    converted copy of the reference's), and draws at its scales."""
    jcfg, tcfg = _cfgs()
    jp, conv = _mixer_params(jcfg, "bfloat16")
    own = TS.mamba2_init(torch.Generator().manual_seed(0), tcfg)
    assert list(own) == list(jp)
    for key, t in own.items():
        assert (conv[key].shape, conv[key].dtype) == (t.shape, t.dtype), key
        np.testing.assert_allclose(conv[key].float().std().item(),
                                   t.float().std().item(), rtol=0.1,
                                   atol=1e-6, err_msg=key)
    assert own["norm"].dtype == torch.float32
    assert own["A_log"].shape == (tcfg.ssm.n_heads,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [32, 96, 20])   # 1 chunk, 3 chunks, < chunk
def test_mamba2_forward_matches_jax(S, with_state, dtype):
    """The output, the final state h_T and the conv tail (the last 3
    pre-conv inputs, bf16), from zeros or a carried state."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mixer_params(jcfg, dtype)
    rng = np.random.default_rng(S)
    jx, tx = _both(rng, dtype, 2, S, jcfg.d_model)
    jstate = tstate = None
    if with_state:
        jstate, tstate = _state(rng, jcfg, 2)
    jy, jst = JS.mamba2_forward(jp, jx, jcfg, state=jstate)
    ty, tst = TS.mamba2_forward(tp, tx, tcfg, state=tstate)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert ty.dtype == tx.dtype and ty.shape == tuple(jy.shape)
    assert tst["ssm"].dtype == torch.float32
    assert tst["ssm"].shape == tuple(jst["ssm"].shape)
    assert tst["conv"].dtype == torch.bfloat16
    assert tst["conv"].shape == tuple(jst["conv"].shape)
    _close(ty, jy, tol)
    _close(tst["ssm"], jst["ssm"], tol)
    _close(tst["conv"], jst["conv"], BF16_TOL)   # bf16 in both packages


def test_mamba2_forward_keeps_the_reference_chunk_assertion():
    """S = 40 is neither a multiple of the chunk (32) nor below it."""
    _, tcfg = _cfgs()
    tp = TS.mamba2_init(torch.Generator().manual_seed(0), tcfg)
    x = torch.zeros(1, 40, tcfg.d_model, dtype=torch.bfloat16)
    with pytest.raises(AssertionError):
        TS.mamba2_forward(tp, x, tcfg)


def test_mamba2_decode_matches_jax():
    """4 decode steps in bf16 from a random carried state: each step's
    output, then the conv window and the state."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mixer_params(jcfg, "bfloat16", seed=1)
    rng = np.random.default_rng(7)
    s = jcfg.ssm
    conv_dim = s.expand * jcfg.d_model + 2 * s.d_state
    jconv, tconv = _both(rng, "bfloat16", 3, conv_dim, s.d_conv - 1)
    jh, th = _state(rng, jcfg, 3)
    jst, tst = dict(jh, conv=jconv), dict(th, conv=tconv)
    for step in range(4):
        jx, tx = _both(rng, "bfloat16", 3, 1, jcfg.d_model)
        jy, jst = JS.mamba2_decode(jp, jx, jst, jcfg)
        ty, tst = TS.mamba2_decode(tp, tx, tst, tcfg)
        assert ty.dtype == torch.bfloat16 and ty.shape == (3, 1, jcfg.d_model)
        _close(ty, jy, BF16_TOL)
    assert tst["ssm"].dtype == torch.float32
    assert tst["conv"].dtype == torch.bfloat16
    _close(tst["ssm"], jst["ssm"], BF16_TOL)
    _close(tst["conv"], jst["conv"], BF16_TOL)


def test_ssd_decay_overflow_stays_finite():
    """A = -200 and dt near 4: above the decay matrix's diagonal cs_i - cs_j
    exceeds 89, where exp overflows float32 to inf, and inf * 0 would be
    NaN if the mask came after the exp.  Output and state stay finite and
    equal the reference's (float32, ``F32_TOL``)."""
    jcfg, tcfg = _cfgs()
    H = jcfg.ssm.n_heads
    jp, tp = _mixer_params(jcfg, "float32", seed=2,
                           A_log=np.full(H, np.log(200.0), np.float32),
                           dt_bias=np.full(H, 4.0, np.float32))
    rng = np.random.default_rng(3)
    jx, tx = _both(rng, "float32", 2, 64, jcfg.d_model)
    dt = F.softplus((tx @ tp["in_proj"])[..., -H:] + tp["dt_bias"])
    assert (dt * 200).min().item() > 89    # exp(-dt A) of one step: inf
    assert torch.isinf(torch.exp(dt * 200)).all()
    jy, jst = JS.mamba2_forward(jp, jx, jcfg)
    ty, tst = TS.mamba2_forward(tp, tx, tcfg)
    assert torch.isfinite(ty).all() and torch.isfinite(tst["ssm"]).all()
    _close(ty, jy, F32_TOL)
    _close(tst["ssm"], jst["ssm"], F32_TOL)


# ---------------------------------------------------------------------------
# the models


@pytest.mark.parametrize("family", ["hybrid", "ssm"])
def test_init_cache_matches_reference(family):
    """Keys, shapes and dtypes of the cache, for the hybrid family (Mamba2
    conv and state of every block, k and v of every superblock) and the
    ssm family at version 2."""
    jcfg, tcfg = _cfgs(family=family)
    jcache, _ = JT.init_cache(jcfg, 3, 40)
    tcache = TT.init_cache(tcfg, 3, 40, device="cpu")
    assert tcache.keys() == jcache.keys()
    for key, t in tcache.items():
        assert t.shape == jcache[key].shape, key
        assert str(t.dtype)[6:] == str(jcache[key].dtype), key
        assert not t.any()
    if family == "hybrid":
        assert tcache["k"].shape[0] == tcfg.n_layers // tcfg.hybrid_attn_every


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_mamba2_models_prefill_and_decode_match_jax(family):
    """zamba2's SMOKE with ``family="ssm"`` (Mamba2 blocks alone) and as
    it is (hybrid): prefill logits and every cache at three chunks of
    prompt, then 4 decode steps fed the JAX package's greedy tokens, at
    ``BF16_TOL``."""
    jcfg, tcfg = _cfgs(family=family)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(_to_numpy(jparams))
    B, S, n_dec = 2, 96, 4
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (B, S))
    jlog, jcache = JT.prefill_forward(
        jcfg, jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
        max_seq=S + n_dec)
    tlog, tcache = TT.prefill_forward(
        tcfg, tparams, {"tokens": torch.from_numpy(tokens)},
        max_seq=S + n_dec)
    _close(tlog, jlog, BF16_TOL)
    assert tcache.keys() == jcache.keys()
    for key in tcache:
        _close(tcache[key], jcache[key], BF16_TOL)
    for i in range(n_dec):
        tok = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
        jlog, jcache = JT.decode_forward(jcfg, jparams, jcache,
                                         jnp.asarray(tok, jnp.int32),
                                         jnp.asarray(S + i, jnp.int32))
        tlog, tcache = TT.decode_forward(tcfg, tparams, tcache,
                                         torch.from_numpy(tok), S + i)
        _close(tlog, jlog, BF16_TOL)
    for key in tcache:
        _close(tcache[key], jcache[key], BF16_TOL)


def test_hybrid_refuses_a_partial_superblock():
    """hybrid_attn_every must divide n_layers (the reference's reshape to
    (n_layers / k, k) fails otherwise)."""
    _, tcfg = _cfgs(n_layers=5)
    with pytest.raises(ValueError, match="hybrid_attn_every"):
        TT.init_params(tcfg, device="cpu")


def test_cpu_launcher_serves_zamba2(capsys):
    """``python -m repro_torch.launch.serve --arch zamba2_2_7b --device
    cpu``: the SMOKE config, 2 requests."""
    tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                 "--max-new", "3"])
    assert "served 2 requests" in capsys.readouterr().out
