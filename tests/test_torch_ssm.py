"""The port's Mamba1 mixer (``repro_torch.models.ssm``) and the selective
scan's state in and out, held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages, at
falcon_mamba_7b's SMOKE size (d_model 64, d_inner 128, N 8) and at N 16,
falcon_mamba_7b's own state size.  On the CPU the port's ``impl="scan"``
runs the scan's plain version (``kernels.ref.mamba_scan_ref``).

Tolerances.  In float32 (params and input float32) the two packages differ
by the order of sums and their exp and softplus, far under the scan's
float32 tolerance, 2e-4 (``tests/test_kernels.py``), which is used here.
In bf16, as the model runs, XLA rounds each op of the conv, silu and
softplus chains to bf16 where torch rounds each torch op once, so values
differ by about one bf16 step a layer: ``BF16_TOL`` (2e-2 relative, plus
2e-2 of the largest magnitude), as in ``tests/test_torch_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import ops, ref
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
MAMBA_F32 = ("A_log", "D", "dt_bias")


def _cfgs(N=8, chunk=256):
    """falcon_mamba_7b's SMOKE config in both packages, at state size N and
    chunk length ``chunk``."""
    out = []
    for mod in (jconfigs, tconfigs):
        cfg = mod.get_smoke_config("falcon_mamba_7b")
        out.append(dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, d_state=N, chunk=chunk)))
    return out


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _close(out, expect, tol):
    expect = _np(expect)
    np.testing.assert_allclose(_np(out), expect, rtol=tol,
                               atol=tol * max(np.abs(expect).max(), 1.0))


def _mixer_params(jcfg, dtype, seed=0):
    """The reference's Mamba1 params and the port's copy of them; in
    float32, every leaf float32 in both."""
    jp = {k: leaf.value for k, leaf in
          JS.mamba1_init(jax.random.PRNGKey(seed), jcfg).items()}
    if dtype == "float32":
        jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
        return jp, {k: torch.from_numpy(_np(v)) for k, v in jp.items()}
    return jp, convert.tree_from_jax(
        {k: np.asarray(v.astype(jnp.float32)) for k, v in jp.items()})


def _both(rng, dtype, *shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


# ---------------------------------------------------------------------------
# the causal conv


@pytest.mark.parametrize("S", [1, 3, 17])
def test_causal_conv1d_and_step_match_jax_exactly(S):
    """float32, bit for bit: the conv as a sum of shifts, and one decode
    step of it from a carried state."""
    rng = np.random.default_rng(S)
    jx, tx = _both(rng, "float32", 2, S, 12)
    jw, tw = _both(rng, "float32", 12, 4)
    jb, tb = _both(rng, "float32", 12)
    np.testing.assert_array_equal(_np(TS.causal_conv1d(tx, tw, tb)),
                                  _np(JS.causal_conv1d(jx, jw, jb)))
    jst, tst = _both(rng, "float32", 2, 12, 3)
    jy, jst2 = JS.conv1d_step(jx[:, 0], jst, jw, jb)
    ty, tst2 = TS.conv1d_step(tx[:, 0], tst, tw, tb)
    np.testing.assert_array_equal(_np(ty), _np(jy))
    np.testing.assert_array_equal(_np(tst2), _np(jst2))


# ---------------------------------------------------------------------------
# the mixer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("impl", ["scan", "unroll4", "chunked"])
@pytest.mark.parametrize("N", [8, 16])
def test_mamba1_forward_matches_jax(N, impl, with_state, dtype):
    """y and both parts of the final state, from zeros or a carried state;
    chunks of 8 steps, so that ``chunked`` crosses chunks at S = 24."""
    jcfg, tcfg = _cfgs(N, chunk=8)
    jp, tp = _mixer_params(jcfg, dtype)
    rng = np.random.default_rng(N)
    jx, tx = _both(rng, dtype, 2, 24, jcfg.d_model)
    jstate = tstate = None
    if with_state:
        d_in = jcfg.ssm.expand * jcfg.d_model
        h0 = rng.standard_normal((2, d_in, N)).astype(np.float32)
        jstate, tstate = {"ssm": jnp.asarray(h0)}, {"ssm": torch.from_numpy(h0)}
    jy, jst = JS.mamba1_forward(jp, jx, jcfg, impl=impl, state=jstate)
    ty, tst = TS.mamba1_forward(tp, tx, tcfg, impl=impl, state=tstate)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert ty.dtype == tx.dtype and ty.shape == tuple(jy.shape)
    assert tst["ssm"].dtype == torch.float32
    assert tst["conv"].dtype == torch.bfloat16
    assert tst["conv"].shape == tuple(jst["conv"].shape)
    _close(ty, jy, tol)
    _close(tst["ssm"], jst["ssm"], tol)
    _close(tst["conv"], jst["conv"], tol)


@pytest.mark.parametrize("N", [8, 16])
def test_mamba1_decode_matches_jax(N):
    """One decode step from a random carried state, in bf16."""
    jcfg, tcfg = _cfgs(N)
    jp, tp = _mixer_params(jcfg, "bfloat16", seed=1)
    rng = np.random.default_rng(10 + N)
    d_in = jcfg.ssm.expand * jcfg.d_model
    jx, tx = _both(rng, "bfloat16", 3, 1, jcfg.d_model)
    jconv, tconv = _both(rng, "bfloat16", 3, d_in, jcfg.ssm.d_conv - 1)
    h = rng.standard_normal((3, d_in, N)).astype(np.float32)
    jy, jst = JS.mamba1_decode(jp, jx, {"conv": jconv, "ssm": jnp.asarray(h)},
                               jcfg)
    ty, tst = TS.mamba1_decode(tp, tx, {"conv": tconv,
                                        "ssm": torch.from_numpy(h)}, tcfg)
    assert ty.dtype == torch.bfloat16 and ty.shape == (3, 1, jcfg.d_model)
    assert tst["ssm"].dtype == torch.float32
    assert tst["conv"].dtype == torch.bfloat16
    _close(ty, jy, BF16_TOL)
    _close(tst["ssm"], jst["ssm"], BF16_TOL)
    np.testing.assert_array_equal(_np(tst["conv"]), _np(jst["conv"]))


def test_unknown_impl_and_mamba2_raise():
    _, tcfg = _cfgs()
    tp = TS.mamba1_init(torch.Generator().manual_seed(0), tcfg)
    x = torch.zeros(1, 8, tcfg.d_model, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="impl"):
        TS.mamba1_forward(tp, x, tcfg, impl="nope")
    with pytest.raises(ValueError, match="unroll3"):
        TS.mamba1_forward(tp, x, tcfg, impl="unroll3")
    # Mamba2 is ported (tests/test_torch_hybrid.py); a version-2 config
    # whose heads do not tile d_inner (0 heads of 64 for 128) fails as the
    # reference's mamba2_init asserts
    jcfg, tcfg = _cfgs()
    jv2, v2 = (dataclasses.replace(c, ssm=dataclasses.replace(c.ssm,
                                                              version=2))
               for c in (jcfg, tcfg))
    with pytest.raises(AssertionError):
        JT.init_params(jv2, jax.random.PRNGKey(0))
    with pytest.raises(AssertionError):
        TT.init_params(v2, device="cpu")


# ---------------------------------------------------------------------------
# the scan's state in and out


def _scan_inputs(seed, b, S, d, N):
    """As tests/test_kernels.py makes them: dt = softplus(z), A = -exp(0.3 z),
    D = 1; and a starting state."""
    rng = np.random.default_rng(seed)
    z = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (z(b, S, d), np.logaddexp(0, z(b, S, d)).astype(np.float32),
            z(b, S, N), z(b, S, N),
            -np.exp(0.3 * z(d, N)).astype(np.float32),
            np.ones(d, np.float32), z(b, d, N))


def _lax_scan(x, dt, B, C, A, D, h0):
    """The reference's scan step (``repro.models.ssm.mamba1_forward``,
    ``impl="scan"``) under ``jax.lax.scan``: (y, h_S)."""
    da = jnp.exp(dt[..., None] * A[None, None])
    dbx = dt[..., None] * B[:, :, None, :] * x[..., None]

    def step(h, inp):
        da_t, dbx_t, C_t = inp
        h = da_t * h + dbx_t
        return h, jnp.einsum("bdn,bn->bd", h, C_t)
    hT, ys = jax.lax.scan(step, h0, (da.transpose(1, 0, 2, 3),
                                     dbx.transpose(1, 0, 2, 3),
                                     C.transpose(1, 0, 2)))
    return ys.transpose(1, 0, 2) + D * x, hT


@pytest.mark.parametrize("b,S,d,N,bd,chunk", [   # tests/test_kernels.py
    (1, 32, 16, 8, 16, 16),
    (2, 64, 32, 16, 16, 32),
    (1, 128, 64, 8, 32, 64),
])
def test_scan_state_matches_jax(b, S, d, N, bd, chunk):
    """From zeros, y against the Pallas kernel in interpret mode and h_S
    against the reference's lax.scan; from a state h0, both against the
    lax.scan; float32 at 2e-4, atol 4 x 2e-4 (tests/test_kernels.py)."""
    *args, h0 = _scan_inputs(b, b, S, d, N)
    jargs, targs = [jnp.asarray(a) for a in args], \
        [torch.from_numpy(a) for a in args]
    kw = dict(rtol=F32_TOL, atol=4 * F32_TOL)
    y, hT = ops.mamba_scan(*targs, return_state=True)
    assert hT.shape == (b, d, N) and hT.dtype == torch.float32
    np.testing.assert_allclose(
        _np(y), _np(jops.mamba_scan(*jargs, bd=bd, chunk=chunk)), **kw)
    _, jhT = _lax_scan(*jargs, jnp.zeros((b, d, N), jnp.float32))
    np.testing.assert_allclose(_np(hT), _np(jhT), **kw)
    y, hT = ops.mamba_scan(*targs, h0=torch.from_numpy(h0), return_state=True)
    jy, jhT = _lax_scan(*jargs, jnp.asarray(h0))
    np.testing.assert_allclose(_np(y), _np(jy), **kw)
    np.testing.assert_allclose(_np(hT), _np(jhT), **kw)
    np.testing.assert_array_equal(    # without return_state: y alone
        _np(ops.mamba_scan(*targs, h0=torch.from_numpy(h0))), _np(y))


def test_scan_split_prompt_equals_one_call():
    """The first half, then the second half from its final state, gives
    one call's y and final state (S = 77: the halves are off any chunk)."""
    *args, h0 = _scan_inputs(4, 2, 77, 40, 16)
    x, dt, B, C, A, D = (torch.from_numpy(a) for a in args)
    h0 = torch.from_numpy(h0)
    y, hT = ref.mamba_scan_ref(x, dt, B, C, A, D, h0=h0, return_state=True)
    y1, h1 = ref.mamba_scan_ref(x[:, :38], dt[:, :38], B[:, :38], C[:, :38],
                                A, D, h0=h0, return_state=True)
    y2, h2 = ref.mamba_scan_ref(x[:, 38:], dt[:, 38:], B[:, 38:], C[:, 38:],
                                A, D, h0=h1, return_state=True)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(h2.numpy(), hT.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h0", [torch.zeros(2, 40, 8),              # shape
                                torch.zeros(2, 40, 16).double(),    # dtype
                                torch.zeros(40, 16)])
def test_scan_refuses_a_mismatched_state(h0):
    x, dt, B, C, A, D = (torch.from_numpy(a)
                         for a in _scan_inputs(5, 2, 9, 40, 16)[:6])
    with pytest.raises(ValueError, match="h0"):
        ops.mamba_scan(x, dt, B, C, A, D, h0=h0)


# ---------------------------------------------------------------------------
# params


def test_converter_keeps_mamba_float32_leaves():
    """A_log, D and dt_bias are float32 in the reference; the converter
    keeps them float32 and bit for bit (A_log = log(1..N) is not exact in
    bf16); the projections come back bf16, bit for bit."""
    jcfg, _ = _cfgs(16)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = convert.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jparams))
    for li, layer in enumerate(tparams["layers"]):
        for key in MAMBA_F32:
            t = layer["ssm"][key]
            expect = np.asarray(jparams["layers"]["ssm"][key][li])
            assert t.dtype == torch.float32 and expect.dtype == np.float32
            np.testing.assert_array_equal(t.numpy().view(np.int32),
                                          expect.view(np.int32))
        t = layer["ssm"]["in_proj"]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(),
            np.asarray(jparams["layers"]["ssm"]["in_proj"][li])
            .view(np.int16))


@pytest.mark.parametrize("N", [8, 16])
def test_mamba1_init_draws_reference_scales_and_dtypes(N):
    """Same keys, shapes and types as the reference's init; the random
    leaves at its scales (std within 10%), the constant ones equal (A_log
    = log(1..N) to one float32 step: XLA's log and torch's round log(7)
    apart)."""
    jcfg, tcfg = _cfgs(N)
    jp = {k: leaf.value for k, leaf in
          JS.mamba1_init(jax.random.PRNGKey(0), jcfg).items()}
    tp = TS.mamba1_init(torch.Generator().manual_seed(0), tcfg)
    assert tp.keys() == jp.keys()
    for key, t in tp.items():
        j = jp[key]
        assert t.shape == j.shape, key
        assert str(t.dtype).split(".")[-1] == str(j.dtype), key
        if key in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj"):
            np.testing.assert_allclose(t.float().std().item(),
                                       float(jnp.std(j.astype(jnp.float32))),
                                       rtol=0.1, err_msg=key)
        elif key == "A_log":
            np.testing.assert_allclose(_np(t), _np(j), rtol=2 ** -23, atol=0)
        else:
            np.testing.assert_array_equal(_np(t), _np(j), err_msg=key)


def test_ssm_cache_layout_matches_jax():
    jcfg = jconfigs.get_smoke_config("falcon_mamba_7b")
    tcfg = tconfigs.get_smoke_config("falcon_mamba_7b")
    jcache, _ = JT.init_cache(jcfg, 3, 40)
    tcache = TT.init_cache(tcfg, 3, 40, device="cpu")
    assert tcache.keys() == jcache.keys()
    for key, t in tcache.items():
        assert t.shape == jcache[key].shape, key
        assert str(t.dtype).split(".")[-1] == str(jcache[key].dtype), key
        assert not t.any()


def test_cpu_launcher_serves_falcon_mamba(capsys, monkeypatch):
    """The CLI with ``--arch falcon_mamba_7b`` serves its SMOKE config, and
    with ``--full`` hands ``serve`` the full config."""
    tserve.main(["--arch", "falcon_mamba_7b", "--device", "cpu",
                 "--requests", "3", "--batch", "2", "--max-new", "3"])
    assert "served 3 requests" in capsys.readouterr().out
    seen = []
    monkeypatch.setattr(tserve, "serve", lambda cfg, **kw: seen.append(cfg))
    tserve.main(["--arch", "falcon_mamba_7b", "--full"])
    assert seen == [tconfigs.get_config("falcon_mamba_7b")]
