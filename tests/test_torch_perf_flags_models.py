"""The port's perf flags held against the JAX package's on whole forwards,
on the CPU: the flagged ``train_forward`` cases, Mamba1's two scans'
gradients and the MoE's einsum dispatch of ``tests/test_perf_flags.py``
(its attention cases are in ``test_torch_perf_flags.py``).

Each case runs on the port, with that
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
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.layers import split_leaves
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.dist import context as tctx
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
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


@pytest.mark.parametrize("arch,flags", [
    ("gemma3_1b", dict(attn_remat_chunk=True, windowed_attention=True)),
    ("falcon_mamba_7b", dict(ssm_impl="chunked")),
    ("phi3_mini_3_8b", dict(attn_remat_chunk=True)),
])
def test_flagged_forward_matches_baseline(arch, flags):
    """The flagged train_forward against the baseline at the reference
    test's tolerance, and against the reference's flagged train_forward at
    ``BF16_TOL``."""
    jcfg, tcfg, jp, tp = _params(arch)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 32))
    tbatch = {"tokens": torch.from_numpy(tokens)}
    base, _ = TT.train_forward(tcfg, tp, tbatch)
    _set_flags(**flags)
    opt, _ = TT.train_forward(tcfg, tp, tbatch)
    np.testing.assert_allclose(_np(base), _np(opt), rtol=0.05, atol=0.05)
    expect, _ = JT.train_forward(
        jcfg, jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    _assert_bf16_close(opt, expect)


def test_ssm_chunked_matches_scan_gradients():
    """Mamba1's input gradient through the scan and through the chunked
    scan agree at the reference test's tolerance, and each matches the
    reference's through the same implementation at ``BF16_TOL``."""
    jcfg = jconfigs.get_smoke_config("falcon_mamba_7b")
    tcfg = tconfigs.get_smoke_config("falcon_mamba_7b")
    jp, _ = split_leaves(JS.mamba1_init(jax.random.PRNGKey(0), jcfg))
    tp = convert.tree_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp))
    x = _normal(1, 2, 64, jcfg.d_model)
    jx = jnp.asarray(x).astype(jnp.bfloat16)

    def tgrad(impl):
        tx = torch.from_numpy(x).bfloat16().requires_grad_()
        y, _ = TS.mamba1_forward(tp, tx, tcfg, impl=impl)
        return torch.autograd.grad((y.float() ** 2).sum(), tx)[0]

    def jgrad(impl):
        return jax.grad(lambda x: jnp.sum(JS.mamba1_forward(
            jp, x, jcfg, impl=impl)[0].astype(jnp.float32) ** 2))(jx)

    g1, g2 = tgrad("scan"), tgrad("chunked")
    np.testing.assert_allclose(_np(g1), _np(g2), rtol=0.1, atol=0.1)
    _assert_bf16_close(g1, jgrad("scan"))
    _assert_bf16_close(g2, jgrad("chunked"))


def test_moe_einsum_dispatch_matches_gather():
    """``moe_apply`` with no dispatch reads ``PerfFlags.moe_dispatch``:
    einsum against gather at the reference test's tolerance, and each
    against the reference under the same flag at ``BF16_TOL``."""
    jcfg = jconfigs.get_smoke_config("granite_moe_1b_a400m")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=8.0))
    tcfg = dataclasses.replace(
        tconfigs.get_smoke_config("granite_moe_1b_a400m"),
        moe=dataclasses.replace(tconfigs.get_smoke_config(
            "granite_moe_1b_a400m").moe, capacity_factor=8.0))
    jp, _ = split_leaves(JM.moe_init(jax.random.PRNGKey(0), jcfg))
    tp = convert.tree_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp))
    x = _normal(1, 2, 16, jcfg.d_model)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).bfloat16()
    a, _ = TM.moe_apply(tp, tx, tcfg)
    ja, _ = JM.moe_apply(jp, jx, jcfg)
    _set_flags(moe_dispatch="einsum")
    b, _ = TM.moe_apply(tp, tx, tcfg)
    jb, _ = JM.moe_apply(jp, jx, jcfg)
    np.testing.assert_allclose(_np(a), _np(b), atol=0.05)
    _assert_bf16_close(a, ja)
    _assert_bf16_close(b, jb)
