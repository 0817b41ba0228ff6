"""The port's MoE family and MLA held against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX
params are carried across with ``repro_torch.convert``.  Dispatch indices
are integers and must be equal.  Routing is compared on identical float32
inputs: the expert indices equal, the weights and aux terms at rtol 1e-5
(summation order).  Whole layers run in bf16 and are held at
``tests/test_torch_serve.py``'s ``BF16_TOL``.  Routing is discontinuous, so
a bf16 difference upstream of a router could move an assignment across the
top-k edge; the layer cases feed both packages the same bf16 input, so
their routers see the same float32 logits up to summation order.
``torch.topk`` and ``jax.lax.top_k`` may order exact ties differently;
random float32 probabilities make such ties vanishingly rare.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.layers import split_leaves
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import attention as TA
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

BF16_TOL = 2e-2          # tests/test_torch_serve.py
ROUTE_RTOL = 1e-5
MOE_ARCHS = ["granite_moe_1b_a400m", "deepseek_v2_lite_16b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _assert_bf16_close(out, expect):
    expect = _np(expect)
    np.testing.assert_allclose(_np(out), expect, rtol=BF16_TOL,
                               atol=BF16_TOL * np.abs(expect).max())


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  tree)


def _configs(arch, capacity_factor=None):
    cfgs = (jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch))
    if capacity_factor is not None:
        cfgs = tuple(dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in cfgs)
    return cfgs


def _moe_params(jcfg, seed=0):
    jp, _ = split_leaves(JM.moe_init(jax.random.PRNGKey(seed), jcfg))
    return jp, convert.tree_from_jax(_to_numpy(jp))


def _bf16_input(seed, *shape):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()


# ---------------------------------------------------------------------------
# dispatch and routing


DISPATCH_CASES = [(64, 2, 8, 16)] + [  # tests/test_dist.py:42-76
    (T, k, E, max(1, math.ceil(T * k * 1.25 / E)))
    for T in (8, 32, 64) for k in (1, 2, 4) for E in (4, 8)]


@pytest.mark.parametrize("T,k,E,C", DISPATCH_CASES)
def test_dispatch_indices_equal_reference(T, k, E, C):
    """Both buffers of ``_dispatch_indices`` equal the reference's, the
    sentinels included, and every assignment that survives lands in the
    slot that holds its token."""
    e_idx = np.random.default_rng(T * k * E).integers(0, E, (T, k))
    jbuf, jslot = JM._dispatch_indices(jnp.asarray(e_idx, jnp.int32), E, 0,
                                       E, C)
    buf, slot = TM._dispatch_indices(torch.from_numpy(e_idx), E, 0, E, C)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    flat = buf.numpy().reshape(-1)
    for t, j in zip(*np.nonzero(slot.numpy() < E * C)):
        assert flat[slot[t, j]] == t
    assert ((buf.numpy() != T).sum(1) <= C).all()


@pytest.mark.parametrize("e_start,e_local", [(0, 3), (3, 4), (6, 2)])
def test_dispatch_indices_of_an_expert_shard_equal_reference(e_start,
                                                             e_local):
    """The slice of experts that an expert-parallel rank would own: slots of
    the other experts are dropped, as the reference drops them."""
    T, k, E, C = 32, 2, 8, 6
    e_idx = np.random.default_rng(7).integers(0, E, (T, k))
    jbuf, jslot = JM._dispatch_indices(jnp.asarray(e_idx, jnp.int32), E,
                                       e_start, e_local, C)
    buf, slot = TM._dispatch_indices(torch.from_numpy(e_idx), E, e_start,
                                     e_local, C)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))


@pytest.mark.parametrize("T,d,E,k", [(64, 64, 4, 2), (96, 64, 32, 8),
                                     (50, 128, 64, 6)])
def test_route_equals_reference_on_identical_inputs(T, d, E, k):
    """float32 tokens and router weights, the same in both: indices equal,
    weights and the two aux terms at rtol 1e-5."""
    rng = np.random.default_rng(T + E)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w_r = (rng.standard_normal((d, E)) / math.sqrt(d)).astype(np.float32)
    jw, jidx, jaux = JM._route(jnp.asarray(x), jnp.asarray(w_r), E, k)
    w, idx, aux = TM._route(torch.from_numpy(x), torch.from_numpy(w_r), E, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=ROUTE_RTOL,
                               atol=0)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=ROUTE_RTOL)
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(aux[key].item(), float(jaux[key]),
                                   rtol=ROUTE_RTOL)


# ---------------------------------------------------------------------------
# the MoE layer


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_matches_reference_tree(arch):
    """The port's own init: the reference's tree, shapes and dtypes (the
    router float32, the expert stacks (E, in, out) bf16), and each leaf's
    std at the reference's scale 1/sqrt(in), within 5 standard errors of a
    sample std (1/sqrt(2n) relative for n draws)."""
    jcfg, cfg = _configs(arch)
    _, conv = _moe_params(jcfg)
    own = TM.moe_init(torch.Generator().manual_seed(0), cfg)
    assert own.keys() == conv.keys()
    assert own["router"].dtype == conv["router"].dtype == torch.float32
    e = cfg.moe
    assert own["gate"].shape == (e.n_experts, cfg.d_model, e.d_ff_expert)
    assert own["down"].shape == (e.n_experts, e.d_ff_expert, cfg.d_model)
    for key in ("router", "gate", "up", "down"):
        assert (own[key].shape, own[key].dtype) == \
            (conv[key].shape, conv[key].dtype), key
        fan_in = own[key].shape[-2]
        rtol = 5 / math.sqrt(2 * own[key].numel())
        for tree in (own, conv):
            np.testing.assert_allclose(tree[key].float().std().item(),
                                       1 / math.sqrt(fan_in), rtol=rtol,
                                       err_msg=key)
    if e.n_shared:
        assert own["shared"]["up"].shape == \
            (cfg.d_model, e.n_shared * e.d_ff_expert)


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(arch, capacity_factor, dispatch):
    """One MoE layer on a bf16 (2, 24) batch, the port's dispatch against
    the reference's (``moe_apply`` or ``moe_apply_einsum``) at
    ``BF16_TOL``, aux terms at rtol 1e-5.  At capacity factor 1.25 experts
    overflow and drop assignments (checked), at 8.0 none does."""
    jcfg, cfg = _configs(arch, capacity_factor)
    jp, tp = _moe_params(jcfg, seed=1)
    jx, tx = _bf16_input(2, 2, 24, cfg.d_model)
    jfn = JM.moe_apply if dispatch == "gather" else JM.moe_apply_einsum
    jout, jaux = jfn(jp, jx, jcfg)
    out, aux = TM.moe_apply(tp, tx, cfg, dispatch=dispatch)
    assert out.dtype == torch.bfloat16 and out.shape == tx.shape
    _assert_bf16_close(out, jout)
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(aux[key].item(), float(jaux[key]),
                                   rtol=ROUTE_RTOL)
    e = cfg.moe
    T = tx.shape[0] * tx.shape[1]
    _, idx, _ = TM._route(tx.reshape(T, -1).float(), tp["router"],
                          e.n_experts, e.top_k)
    most = int(torch.bincount(idx.reshape(-1), minlength=e.n_experts).max())
    assert (most > TM._capacity(T, e)) == (capacity_factor == 1.25)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gather_matches_einsum(arch):
    """The port's two dispatches on one input at capacity factor 8.0, at
    tests/test_perf_flags.py:105-119's atol 0.05."""
    jcfg, cfg = _configs(arch, 8.0)
    _, tp = _moe_params(jcfg)
    _, tx = _bf16_input(1, 2, 16, cfg.d_model)
    a, _ = TM.moe_apply(tp, tx, cfg, dispatch="gather")
    b, _ = TM.moe_apply(tp, tx, cfg, dispatch="einsum")
    np.testing.assert_allclose(_np(a), _np(b), atol=0.05)


def test_moe_apply_refuses_an_unknown_dispatch():
    jcfg, cfg = _configs("granite_moe_1b_a400m")
    _, tp = _moe_params(jcfg)
    with pytest.raises(ValueError, match="dispatch"):
        TM.moe_apply(tp, torch.zeros(1, 2, cfg.d_model), cfg, dispatch="x")


@pytest.mark.parametrize("T,expect", [(4, 2), (4096, 1280), (1, 1)])
def test_capacity_at_the_serving_shapes(T, expect):
    """granite_moe_1b_a400m's capacity: 2 at SERVE's decode batch of 4
    tokens (decode drops by design), 1280 at 4 x 1024 prefill tokens."""
    assert TM._capacity(T, tconfigs.get_config("granite_moe_1b_a400m").moe) \
        == expect


def test_deepseek_capacity_at_the_serving_shapes():
    e = tconfigs.get_config("deepseek_v2_lite_16b").moe
    assert (TM._capacity(4, e), TM._capacity(4096, e)) == (1, 480)


# ---------------------------------------------------------------------------
# MLA


def _mla_setup(seed):
    jcfg, cfg = _configs("deepseek_v2_lite_16b")
    jp, _ = split_leaves(JA.attn_init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, jp, convert.tree_from_jax(_to_numpy(jp))


def test_mla_params_keep_kv_norm_float32():
    _, cfg, _, tp = _mla_setup(0)
    own = TA.attn_init(torch.Generator().manual_seed(0), cfg)
    assert own.keys() == tp.keys() == {"q", "kv_a", "kv_norm", "kv_b", "o"}
    for key in own:
        assert (own[key].shape, own[key].dtype) == \
            (tp[key].shape, tp[key].dtype), key
    assert own["kv_norm"].dtype == torch.float32


def test_rope_tables_take_mla_rope_dim():
    for arch in MOE_ARCHS:
        jcfg, cfg = _configs(arch)
        jcos, _ = JT._rope_for(jcfg, jnp.arange(5))
        tcos, _ = TT._rope_for(cfg, torch.arange(5))
        assert tcos.shape == jcos.shape
        np.testing.assert_allclose(tcos.numpy(), _np(jcos), rtol=1e-6)


def test_mla_forward_matches_reference():
    """Prefill MLA at the smoke widths (q/k head dim 16 + 8, v 16 padded to
    24 for the flash path): the output and both cache parts at
    ``BF16_TOL``."""
    jcfg, cfg, jp, tp = _mla_setup(2)
    S = 21
    jx, tx = _bf16_input(3, 2, S, cfg.d_model)
    jcos, jsin = JT._rope_for(jcfg, jnp.arange(S))
    tcos, tsin = TT._rope_for(cfg, torch.arange(S))
    jout, (jckv, jkr) = JA.mla_forward(jp, jx, jcos, jsin, cfg=jcfg)
    out, (ckv, kr) = TA.mla_forward(tp, tx, tcos, tsin, cfg=cfg)
    m = cfg.mla
    assert out.shape == tx.shape and ckv.shape == (2, S, m.kv_lora_rank) \
        and kr.shape == (2, S, m.qk_rope_dim)
    _assert_bf16_close(out, jout)
    _assert_bf16_close(ckv, jckv)
    _assert_bf16_close(kr, jkr)


def test_mla_decode_over_four_steps_matches_reference():
    """Absorbed-form decode for 4 steps after a 12-token prefix written into
    both packages' caches: each step's output, and the caches that each
    step writes in place at ``pos``, at ``BF16_TOL``."""
    jcfg, cfg, jp, tp = _mla_setup(4)
    m = cfg.mla
    B, S, P = 2, 16, 12
    rng = np.random.default_rng(5)
    ckv = np.zeros((B, S, m.kv_lora_rank), np.float32)
    kr = np.zeros((B, S, m.qk_rope_dim), np.float32)
    ckv[:, :P] = rng.standard_normal((B, P, m.kv_lora_rank))
    kr[:, :P] = rng.standard_normal((B, P, m.qk_rope_dim))
    jckv, jkr = (jnp.asarray(a).astype(jnp.bfloat16) for a in (ckv, kr))
    tckv, tkr = (torch.from_numpy(a).bfloat16() for a in (ckv, kr))
    for step in range(4):
        pos = P + step
        jx, tx = _bf16_input(10 + step, B, 1, cfg.d_model)
        jcos, jsin = JT._rope_for(jcfg, jnp.full((1,), pos))
        tcos, tsin = TT._rope_for(cfg, torch.full((1,), pos))
        jout, jckv, jkr = JA.mla_decode(jp, jx, jckv, jkr, jcos, jsin,
                                        cfg=jcfg, pos=jnp.asarray(pos))
        out, ckv2, kr2 = TA.mla_decode(tp, tx, tckv, tkr, tcos, tsin,
                                       cfg=cfg, pos=pos)
        assert ckv2 is tckv and kr2 is tkr   # updated in place
        _assert_bf16_close(out, jout)
        _assert_bf16_close(tckv, jckv)
        _assert_bf16_close(tkr, jkr)


# ---------------------------------------------------------------------------
# the block inside the model


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_backbone_aux_terms_match_reference(arch):
    """The backbone's layer-averaged load-balance and router-z terms (which
    prefill drops and training will use) against the reference's
    ``train_forward`` aux on the same tokens, at ``BF16_TOL``: each layer's
    router sees its block's bf16 input, which the two packages round alike
    only up to a bf16 step."""
    jcfg, cfg = _configs(arch)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(_to_numpy(jparams))
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 12))
    _, jaux = JT.train_forward(jcfg, jparams,
                               {"tokens": jnp.asarray(tokens, jnp.int32)})
    x = TT._embed_tokens(cfg, tparams, torch.from_numpy(tokens))
    _, (lb, rz), states = TT._backbone(cfg, tparams, x, torch.arange(12))
    assert len(states) == cfg.n_layers
    np.testing.assert_allclose(lb.item(), float(jaux["load_balance"]),
                               rtol=BF16_TOL)
    np.testing.assert_allclose(rz.item(), float(jaux["router_z"]),
                               rtol=BF16_TOL)
