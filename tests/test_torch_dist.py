"""The port's distribution layer held against the JAX package's, on the
CPU: gradient compression, the mesh accessors, tensor-parallel
projections, and the sharding rule engine with the models' logical-axes
trees.

The reference's own cases (``tests/test_dist.py:16-41``,
``tests/test_sharding.py``) run on the port.  Beside them the pure-Python
rule engine is held ``==`` against the reference's on every arch x shape
cell of both production meshes; the quantizer takes the reference's noise
and must give its int8 blocks exactly; and multi-rank cases run in gloo
process groups (``_torch_dist.spawn``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro import configs as jconfigs
from repro.core import config as jconfig
from repro.dist import compress as jcompress
from repro.dist import context as jctx
from repro.dist import sharding as jsharding
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.core import config as tconfig
from repro_torch.core import tree
from repro_torch.dist import compress
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import sharding
from repro_torch.dist.sharding import P, Rules, default_rules, rules_for
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as T

PROD_MESHES = ({"data": 16, "model": 16},
               {"pod": 2, "data": 16, "model": 16})


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def host_mesh():
    """A (1, 1) mesh on a world-1 gloo group of this process, the group
    destroyed after."""
    import torch.distributed as dist
    mesh = make_host_mesh(1, 1, device_type="cpu")
    yield mesh
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# gradient compression (tests/test_dist.py:16-41)


def test_quantize_roundtrip_error_bounded():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 3.0
    q, scale = compress.quantize_int8(x, torch.Generator().manual_seed(1))
    deq = compress.dequantize_int8(q, scale, x.shape, x.numel())
    err = (deq - x).abs()
    # per-block max is 127*scale; quantization error <= scale (1 LSB)
    blocks = torch.nn.functional.pad(x, (0, (-x.numel()) % 256))
    lsb = blocks.reshape(-1, 256).abs().amax(1) / 127.0
    assert float(err.max()) <= float(lsb.max()) * 1.01 + 1e-6


def test_error_feedback_converges():
    """With error feedback, the running quantized sum tracks the true sum."""
    g = {"w": torch.ones(300) * 0.01}
    err = None
    total_q = torch.zeros(300)
    for i in range(20):
        out, err = compress.compressed_psum_grads(
            g, _FakeMesh({}), "data", torch.Generator().manual_seed(i), err)
        total_q = total_q + out["w"]
    true = 20 * 0.01
    assert float((total_q - true).abs().max()) < 5e-4


@pytest.mark.parametrize("shape,scale", [((1000,), 3.0), ((3, 300), 0.01),
                                         ((256,), 1.0), ((7,), 0.0)])
def test_quantize_int8_matches_reference_on_its_noise(monkeypatch, shape,
                                                      scale):
    """The reference's blocks, scales and dequantized values, ``==``, when
    the port draws the reference's ``jax.random`` noise."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) \
        * scale
    rng = jax.random.PRNGKey(3)
    q_ref, s_ref = jcompress.quantize_int8(jnp.asarray(x), rng)
    n = int(np.prod(shape))
    noise = np.asarray(jax.random.uniform(rng, ((n + 255) // 256, 256),
                                          minval=-0.5, maxval=0.5))
    monkeypatch.setattr(compress, "_uniform",
                        lambda shp, gen, dev: torch.from_numpy(noise.copy()))
    q, s = compress.quantize_int8(torch.from_numpy(x), None)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(
        compress.dequantize_int8(q, s, shape, n).numpy(),
        np.asarray(jcompress.dequantize_int8(q_ref, s_ref, shape, n)))


def test_compressed_psum_grads_two_ranks(tmp_path):
    """Over a (data 2) mesh each rank gets the mean of both ranks'
    dequantized leaves, and keeps its own residual; the mesh accessors
    read the real mesh."""
    gen = torch.Generator().manual_seed(5)
    grads = [{"a": torch.randn(300, generator=gen),
              "b": {"c": torch.randn(4, 70, generator=gen)}}
             for _ in range(2)]
    ranks = _torch_dist.spawn(_torch_dist.rank_compress, 2, tmp_path, grads,
                              11)
    alone = [compress.compressed_psum_grads(
        grads[r], None, "data", torch.Generator().manual_seed(11 + r))
        for r in range(2)]
    for r, (out, res, sizes) in enumerate(ranks):
        assert sizes == (2, 1, 1, "data")
        for key, v in tree.flatten(out).items():
            mean = (tree.flatten(alone[0][0])[key]
                    + tree.flatten(alone[1][0])[key]) / 2
            torch.testing.assert_close(v, mean, rtol=0, atol=1e-7)
        for key, v in tree.flatten(res).items():
            assert torch.equal(v, tree.flatten(alone[r][1])[key])


# ---------------------------------------------------------------------------
# the mesh accessors


@pytest.mark.parametrize("shape", [{}, {"data": 1, "model": 1},
                                   {"data": 4}, *PROD_MESHES,
                                   {"pod": 2, "data": 1, "model": 4}])
def test_mesh_axis_size_and_dp_axes_on_fake_meshes(shape):
    try:
        dist_ctx.set_mesh(_FakeMesh(shape))
        jctx.set_mesh(_FakeMesh(shape))
        for name in ("pod", "data", "model", "stage"):
            assert dist_ctx.mesh_axis_size(name) == jctx.mesh_axis_size(name)
        assert dist_ctx.dp_axes() == jctx.dp_axes()
    finally:
        dist_ctx.set_mesh(None)
        jctx.set_mesh(None)
    assert dist_ctx.mesh_axis_size("data") == 1 and dist_ctx.dp_axes() is None


def test_mesh_accessors_on_a_real_host_mesh(host_mesh):
    assert host_mesh.mesh_dim_names == ("data", "model")
    with _torch_dist.mesh_installed(host_mesh):
        assert dist_ctx.mesh_axis_size("data") == 1
        assert dist_ctx.mesh_axis_size("model") == 1
        assert dist_ctx.dp_axes() is None
        assert dist_ctx.shard_of("data") == (0, 1)


def test_production_mesh_needs_its_ranks():
    """On one process, the reference's RuntimeError with the rank count,
    and no process group left behind."""
    import torch.distributed as dist
    with pytest.raises(RuntimeError, match="need 256 devices, have 1; run "
                       "under torchrun --nproc-per-node 256"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="need 512 devices"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    assert not dist.is_initialized()


def test_tp_project_on_two_ranks(tmp_path):
    """``tp_project`` of x @ w split over 2 ``model`` ranks, inside a
    bound region, equals the unsplit product (float32 at 1e-5; bf16 on
    the wire at 1e-2), and a swiglu ``mlp_apply`` with d_ff split equals
    the unsplit MLP; outside a bound region each rank keeps its partial."""
    from repro_torch.models.layers import mlp_apply, mlp_init
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 64, generator=gen)
    w = torch.randn(64, 32, generator=gen) / 8
    mlp = mlp_init(gen, 64, 64, "swiglu")
    ranks = _torch_dist.spawn(_torch_dist.rank_tp, 2, tmp_path, x, w, mlp,
                              (False, True))
    full_mlp = mlp_apply(mlp, x.to(torch.bfloat16), "swiglu").float()
    for r, out in enumerate(ranks):
        part = slice(32 * r, 32 * (r + 1))
        torch.testing.assert_close(out["unbound"], x[..., part] @ w[part])
        torch.testing.assert_close(out[False][0], x @ w, rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(out[True][0], x @ w, rtol=1e-2, atol=1e-2)
        for flag in (False, True):
            got = out[flag][1].float()
            scale = float(full_mlp.abs().max())
            assert float((got - full_mlp).abs().max()) <= 2e-2 * scale
        assert torch.equal(ranks[0][False][0], ranks[1][False][0])


def test_mlp_and_o_projection_unchanged_off_a_mesh():
    """Off a mesh ``mlp_apply`` is x @ up/gate then @ down, bit for bit."""
    from repro_torch.models.layers import _act, mlp_apply, mlp_init
    gen = torch.Generator().manual_seed(1)
    mlp = mlp_init(gen, 32, 48, "swiglu")
    x = torch.randn(2, 5, 32, generator=gen).to(torch.bfloat16)
    expect = (_act("swiglu", x @ mlp["gate"]) * (x @ mlp["up"])) \
        @ mlp["down"]
    assert torch.equal(mlp_apply(mlp, x, "swiglu"), expect)


# ---------------------------------------------------------------------------
# the rule engine: every case of tests/test_sharding.py


def test_divisibility_guard_falls_back_to_replicated(host_mesh):
    rules = default_rules(host_mesh)
    # axis of size 1 -> never sharded
    assert rules.spec_for(("vocab", "d_model"), (100, 64)) == P()


def test_spec_construction(host_mesh):
    r = Rules(table={"batch": "data", "d_ff": "model"}, mesh=host_mesh)
    spec = r.spec_for(("batch", None, "d_ff"), (8, 4, 16))
    assert spec == P()  # both axes size 1 -> unsharded


def test_rules_for_long_context_uses_sequence_parallel():
    cfg = tconfigs.get_config("gemma3_1b")
    shape = tconfig.SHAPE_BY_NAME["long_500k"]
    r = rules_for(cfg, shape, _FakeMesh({"data": 16, "model": 16}))
    assert r.table["batch"] is None          # batch=1 cannot shard
    assert r.table["kv_seq"] == "data"       # SP takes over
    # MQA fallback: kv head_dim sharded instead of kv_heads
    assert r.table["head_dim"] == "model"


def test_rules_for_train_shards_batch():
    cfg = tconfigs.get_config("tinyllama_1_1b")
    shape = tconfig.SHAPE_BY_NAME["train_4k"]
    r = rules_for(cfg, shape, _FakeMesh({"pod": 2, "data": 16, "model": 16}))
    assert r.table["batch"] == ("pod", "data")
    assert r.table["heads_x_dim"] == "model"   # 32 % 16 == 0
    assert r.table["kv_heads_x_dim"] is None   # 4 % 16 != 0 -> replicated


def test_all_cells_have_consistent_rules():
    for arch in tconfigs.ARCH_IDS:
        cfg = tconfigs.get_config(arch)
        for shape in tconfig.SHAPES:
            r = rules_for(cfg, shape, _FakeMesh({"data": 16, "model": 16}))
            assert isinstance(r.table, dict)


@pytest.mark.parametrize("mesh", PROD_MESHES, ids=("single", "multi_pod"))
def test_default_rules_and_tables_match_reference(mesh):
    assert default_rules(_FakeMesh(mesh)).table == \
        jsharding.default_rules(_FakeMesh(mesh)).table
    for arch in tconfigs.ARCH_IDS:
        for ts, js in zip(tconfig.SHAPES, jconfig.SHAPES):
            assert rules_for(tconfigs.get_config(arch), ts,
                             _FakeMesh(mesh)).table == \
                jsharding.rules_for(jconfigs.get_config(arch), js,
                                    _FakeMesh(mesh)).table


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    r = Rules(table={}, mesh=_FakeMesh({"pod": 2, "data": 16, "model": 16}))
    assert r.placements(P(("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert r.placements(P()) == (Replicate(),) * 3
    assert r.placements(P(None, "data")) == (Replicate(), Shard(1),
                                             Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        r.placements(P(("data", "pod")))


def test_constrain_is_the_identity_off_a_mesh(host_mesh):
    x = torch.ones(4, 8)
    assert sharding.constrain(x, ("batch", None)) is x
    with _torch_dist.mesh_installed(host_mesh, default_rules(host_mesh)):
        assert sharding.constrain(x, ("batch", None)) is x   # a local shard
    sharding.set_active_rules(Rules({"batch": "data"}, _FakeMesh({"data": 2})))
    try:
        assert sharding.constrain(x, ("batch", None)) is x   # no real mesh
    finally:
        sharding.set_active_rules(None)


# ---------------------------------------------------------------------------
# the models' logical-axes trees and their specs, against the reference


def _map(t, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in t.items()}


@functools.lru_cache(maxsize=None)
def _reference_trees(arch):
    """The reference's params axes and shapes of ``arch``'s full config
    (traced, not allocated), in the port's layout: each leaf (axes,
    shape), a stacked leaf's without its leading layer entry."""
    cfg = jconfigs.get_config(arch)
    holder = {}

    def init(key):
        params, axes = JT.init_params(cfg, key)
        holder["axes"] = axes
        return params
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    pairs = _zip(holder["axes"], shapes)
    out = {k: v for k, v in pairs.items() if k not in ("layers", "encoder")}

    def unstack(stack):
        n = _first_shape(stack)
        return [_map_pairs(stack, lambda a, s: (a[1:], s[1:]))
                for _ in range(n)]
    out["layers"] = unstack(pairs["layers"])
    if "encoder" in pairs:
        enc = pairs["encoder"]
        out["encoder"] = {"layers": unstack(enc["layers"]),
                          **{k: v for k, v in enc.items() if k != "layers"}}
    # the stacked leaves' own axes and shapes, for their specs
    return out, pairs


def _zip(axes, shapes):
    if isinstance(axes, dict):
        return {k: _zip(axes[k], shapes[k]) for k in axes}
    return (axes, tuple(shapes.shape))


def _map_pairs(t, fn):
    if isinstance(t, dict):
        return {k: _map_pairs(v, fn) for k, v in t.items()}
    return fn(*t)


def _first_shape(t):
    v = next(iter(t.values()))
    return _first_shape(v) if isinstance(v, dict) else v[1][0]


def _pair_leaves(t, prefix=""):
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(_pair_leaves(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(t, list):
        out = {}
        for i, v in enumerate(t):
            out.update(_pair_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: t}


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_axes_match_reference(arch):
    """``param_axes`` equals the reference's axes tree leaf for leaf in the
    port's layout; the port's SMOKE params have the reference's shapes
    there, one leaf for each axes leaf."""
    ref, _ = _reference_trees(arch)
    ref_leaves = _pair_leaves(ref)
    ours = T.param_axes(tconfigs.get_config(arch))
    got = {}
    sharding.map_axes(lambda a, key: got.__setitem__(key, a), ours,
                      _keys_tree(ours))
    assert got == {k: a for k, (a, _) in ref_leaves.items()}
    # the SMOKE params: same structure, shapes the reference's
    scfg = tconfigs.get_smoke_config(arch)
    sparams = T.init_params(scfg, 0, "cpu")
    jcfg = jconfigs.get_smoke_config(arch)
    jshapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k)[0],
                             jax.random.PRNGKey(0))
    flat = tree.flatten(sparams)
    ref_flat = _pair_leaves(_smoke_shapes(jshapes))
    assert {k: tuple(v.shape) for k, v in flat.items()} == ref_flat
    _assert_ranks(T.param_axes(scfg), sparams)


def _assert_ranks(axes_tree, tensors):
    """One logical axis for each dimension of every leaf."""
    def check(axes, t):
        assert len(axes) == t.dim(), (axes, tuple(t.shape))
    sharding.map_axes(check, axes_tree, tensors)


def _shape_tree(t):
    return _map(t, lambda s: tuple(s.shape))


def _smoke_shapes(jshapes):
    t = _shape_tree(jshapes)
    out = {k: v for k, v in t.items() if k not in ("layers", "encoder")}

    def unstack(stack):
        n = _first_stack_len(stack)
        return [_map(stack, lambda s: s[1:]) for _ in range(n)]
    out["layers"] = unstack(t["layers"])
    if "encoder" in t:
        out["encoder"] = {"layers": unstack(t["encoder"]["layers"]),
                          **{k: v for k, v in t["encoder"].items()
                             if k != "layers"}}
    return out


def _first_stack_len(t):
    v = next(iter(t.values()))
    return _first_stack_len(v) if isinstance(v, dict) else v[0]


def _keys_tree(axes_tree, prefix=""):
    if isinstance(axes_tree, dict):
        return {k: _keys_tree(v, f"{prefix}/{k}" if prefix else k)
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [_keys_tree(v, f"{prefix}/{i}")
                for i, v in enumerate(axes_tree)]
    return prefix


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cache_axes_match_reference(arch):
    for cfg_of in (jconfigs.get_config, jconfigs.get_smoke_config):
        jcfg = cfg_of(arch)
        tcfg = getattr(tconfigs, cfg_of.__name__)(arch)
        holder = {}

        def init():
            cache, axes = JT.init_cache(jcfg, 2, 64)
            holder["axes"] = axes
            return cache
        jax.eval_shape(init)
        assert T.cache_axes(tcfg, 2, 64) == holder["axes"]
    cache = T.init_cache(tcfg, 2, 64, "cpu")
    _assert_ranks(T.cache_axes(tcfg, 2, 64), cache)


@pytest.mark.parametrize("mesh", PROD_MESHES, ids=("single", "multi_pod"))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_spec_for_matches_reference_on_every_leaf(arch, mesh):
    """``rules_for(...).spec_for`` entry for entry equal to the
    reference's, for every param leaf of ``param_axes`` (a block's leaf
    against the reference's stacked leaf, its leading ``layers`` entry,
    never sharded, dropped) and every cache leaf of ``cache_axes``, on
    every shape of the production mesh."""
    ours, stacked = _reference_trees(arch)
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    our_axes = T.param_axes(tcfg)
    for ts, js in zip(tconfig.SHAPES, jconfig.SHAPES):
        tr = rules_for(tcfg, ts, _FakeMesh(mesh))
        jr = jsharding.rules_for(jcfg, js, _FakeMesh(mesh))
        ref_specs = {}
        for key, (a, s) in _pair_leaves(stacked).items():
            spec = tuple(jr.spec_for(a, s))
            if a and a[0] == "layers":
                assert not spec or spec[0] is None
                spec = spec[1:] if any(e is not None for e in spec) else ()
            ref_specs[key] = spec
        leaves = _pair_leaves(ours)
        got = {}
        sharding.map_axes(
            lambda a, key: got.__setitem__(
                key, tuple(tr.spec_for(a, leaves[key][1]))),
            our_axes, _keys_tree(our_axes))
        for key, spec in got.items():
            parts = key.split("/")
            if parts[0] == "layers":
                ref_key = "/".join(["layers"] + parts[2:])
            elif parts[:2] == ["encoder", "layers"]:
                ref_key = "/".join(["encoder", "layers"] + parts[3:])
            else:
                ref_key = key
            assert spec == ref_specs[ref_key], (arch, ts.name, key)
        # the caches, at the shape's own batch and sequence
        holder = {}

        def init():
            cache, axes = JT.init_cache(jcfg, js.global_batch, js.seq_len)
            holder["axes"] = axes
            return cache
        shapes = jax.eval_shape(init)
        cax = T.cache_axes(tcfg, ts.global_batch, ts.seq_len)
        for key, a in cax.items():
            s = tuple(shapes[key].shape)
            assert tuple(tr.spec_for(a, s)) == \
                tuple(jr.spec_for(holder["axes"][key], s)), (arch, key)


def test_tree_shardings_gives_placements_per_leaf():
    from torch.distributed.tensor import Replicate, Shard
    cfg = tconfigs.get_smoke_config("granite_moe_1b_a400m")
    params = T.init_params(cfg, 0, "cpu")
    r = rules_for(cfg, tconfig.SHAPE_BY_NAME["train_4k"],
                  _FakeMesh({"data": 2, "model": 2}))
    sh = r.tree_shardings(T.param_axes(cfg), params)
    assert sh["layers"][0]["moe"]["gate"] == (Replicate(), Shard(0))
    assert sh["layers"][0]["norm1"] == (Replicate(), Replicate())
    assert len(sh["layers"]) == cfg.n_layers
