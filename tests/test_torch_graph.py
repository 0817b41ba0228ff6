"""The port's graph frontend and executor held against the JAX package's.

Graphs are built with both packages' builders from the same numpy arrays
(or read from the other package's files) and run on the CPU, where the port's
convolution and matmul nodes take the plain version of the NVDLA matmul.
The reference graph path never reaches a Pallas kernel (``Graph.execute``
runs jnp), so it is compared as it runs.

Tolerances:

- a convolution or matmul node, fed the reference's own input values: the
  float32 matmul tolerance of ``tests/test_kernels.py``, rtol 2e-4 and atol
  2e-4 sqrt(K), with K = kh kw cin for a convolution;
- the other nodes, fed the same way: rtol 1e-5, atol 1e-5, since they are
  float32 elementwise work whose reductions (batch norm's statistics) and
  transcendentals (gelu's tanh) round in another order;
- a graph's outputs, each package running its own chain: rtol 1e-4, atol
  1e-4 max|reference|, because the products' rounding compounds over up to
  13 layers and batch norm divides by a batch std (observed about 2e-6 of
  max|reference| on the five nets).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.apps.paper_graphs import build_paper_graph as ref_build
from repro.configs.paper_nets import PAPER_NETS as REF_NETS
from repro.core import graph as RG
from repro.core import graph_ops as RGO
from repro_torch.apps.paper_graphs import build_paper_graph
from repro_torch.configs.paper_nets import PAPER_NETS
from repro_torch.core import graph as TG
from repro_torch.core import graph_ops as TGO
from repro_torch.kernels import nvdla_matmul as mm

MM_TOL = 2e-4
NODE_TOL = 1e-5
OUT_TOL = 1e-4
# the NVDLA matmul's launches by variant along each net's forward, from the
# shapes of its conv and FC nodes and nvdla_matmul.variant's float32 rule:
# {net: {batch: (tf32x3, stream)}}
LAUNCHES = {"minerva": {1: (0, 4), 64: (4, 0)},
            "lenet5": {1: (2, 2), 64: (4, 0)},
            "cnn10": {1: (4, 2), 64: (6, 0)},
            "vgg16": {1: (7, 5), 64: (12, 0)},
            "elu16": {1: (5, 6), 64: (11, 0)}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_values(g, feeds, fuse=True):
    """Every node's value from the reference: the loop of its
    ``Graph.execute`` (``repro/core/graph.py:106-123``), all values kept."""
    vals = {}
    fused = g.fusion_plan() if fuse else {}
    for name in g.order:
        n = g.nodes[name]
        if n.op == "input":
            vals[name] = jnp.asarray(feeds[name])
        elif n.op == "weight":
            vals[name] = jnp.asarray(g.params[name])
        elif name not in fused:
            vals[name] = RGO.run_node(g, n, vals, fused)
    return vals


def _k(tg, n):
    """K of a convolution or matmul node's product."""
    w = tg.nodes[n.inputs[1]].shape
    return int(np.prod(w[:-1]))


def _same_structure(tg, rg):
    assert tg.name == rg.name and tg.backend == rg.backend
    assert tg.order == rg.order
    assert tg.inputs == rg.inputs and tg.outputs == rg.outputs
    for name in rg.order:
        t, r = tg.nodes[name], rg.nodes[name]
        assert (t.op, t.inputs, t.attrs, tuple(t.shape)) == \
            (r.op, r.inputs, r.attrs, tuple(r.shape)), name
    assert sorted(tg.params) == sorted(rg.params)
    for name, arr in rg.params.items():
        assert tg.params[name].dtype == arr.dtype == np.float32
        np.testing.assert_array_equal(tg.params[name], arr)


def _assert_matches_reference(tg, rg, feeds, fuse=True):
    """Node by node on the reference's inputs, then the outputs of the two
    chains.  Returns the port's outputs."""
    _same_structure(tg, rg)
    assert tg.fusion_plan() == rg.fusion_plan()
    ref = _ref_values(rg, feeds, fuse)
    plan = tg.fusion_plan() if fuse else {}
    for name in tg.order:
        n = tg.nodes[name]
        if n.op in ("input", "weight") or name in plan:
            continue
        vals = {i: torch.from_numpy(np.array(ref[i])) for i in n.inputs}
        out = TGO.run_node(tg, n, vals, plan)
        vals[name] = out
        if n.op in ("convolution", "matmul"):
            rtol, atol = MM_TOL, MM_TOL * _k(tg, n) ** 0.5
        else:
            rtol = atol = NODE_TOL
        for key in [name] + [c for c, p in plan.items() if p == name]:
            assert vals[key].dtype == torch.float32, key
            np.testing.assert_allclose(vals[key].numpy(), np.asarray(ref[key]),
                                       rtol=rtol, atol=atol, err_msg=key)
    out = tg.execute(feeds, fuse=fuse, device="cpu")
    expect = {o: np.asarray(ref[o]) for o in rg.outputs}
    assert sorted(out) == sorted(expect)
    for o, e in expect.items():
        np.testing.assert_allclose(out[o].numpy(), e, rtol=OUT_TOL,
                                   atol=OUT_TOL * np.abs(e).max(), err_msg=o)
    return out


# -- one op at a time --------------------------------------------------------

def _conv_case(k, stride, padding, activation=None, feed_dtype=np.float32):
    def build(G):
        rng = np.random.default_rng(0)
        with G.Graph("conv") as g:
            x = G.input_data("input", np.zeros((2, 7, 9, 3)))
            w = G.weight("w", rng.standard_normal((k, k, 3, 5)) * 0.3)
            G.convolution("conv", x, w, stride=stride, padding=padding,
                          activation=activation)
        return g, {"input": rng.standard_normal((2, 7, 9, 3))
                   .astype(feed_dtype)}
    return build


def _matmul_case(activation):
    """An FC node on a 4-d input: flattened in NHWC order first."""
    def build(G):
        rng = np.random.default_rng(1)
        with G.Graph("fc") as g:
            x = G.input_data("input", np.zeros((3, 4, 5, 2)))
            w = G.weight("w", rng.standard_normal((40, 7)) * 0.2)
            G.matmul("fc", x, w, activation=activation)
        return g, {"input": rng.standard_normal((3, 4, 5, 2))
                   .astype(np.float32)}
    return build


def _add_relu(G):
    rng = np.random.default_rng(2)
    with G.Graph("add") as g:
        a = G.input_data("a", np.zeros((2, 3, 3, 4)))
        b = G.input_data("b", np.zeros((2, 3, 3, 4)))
        s = G.add("sum", a, b, activation="relu")
        G.relu("act", G.add("twice", s, a))
    return g, {k: rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
               for k in ("a", "b")}


def _pool_case(k, h, w):
    def build(G):
        rng = np.random.default_rng(3)
        with G.Graph("pool") as g:
            x = G.input_data("input", np.zeros((2, h, w, 3)))
            G.max_pool("pool", x, k)
        return g, {"input": rng.standard_normal((2, h, w, 3))
                   .astype(np.float32)}
    return build


def _batch_norm(G):
    """Scale and bias other than 1 and 0, swapped into ``params`` after the
    build as the reference allows (paper §II-A)."""
    rng = np.random.default_rng(4)
    with G.Graph("bn") as g:
        x = G.input_data("input", np.zeros((3, 5, 6, 4)))
        G.flatten("flat", G.batch_norm("bn", x))
    g.params["bn_scale"] = rng.standard_normal(4).astype(np.float32)
    g.params["bn_bias"] = rng.standard_normal(4).astype(np.float32)
    return g, {"input": (2.0 + 3.0 * rng.standard_normal((3, 5, 6, 4)))
               .astype(np.float32)}


def _fused(op, producer="convolution"):
    """A convolution (or an FC node) without activation whose one consumer
    is a ``relu`` or ``gelu`` node: the fusion pass folds the consumer into
    it."""
    def build(G):
        rng = np.random.default_rng(5)
        with G.Graph("fused") as g:
            x = G.input_data("input", np.zeros((1, 6, 6, 2)))
            if producer == "convolution":
                w = G.weight("w", rng.standard_normal((3, 3, 2, 4)) * 0.5)
                h = G.convolution("conv", x, w)
            else:
                w = G.weight("w", rng.standard_normal((72, 4)) * 0.5)
                h = G.matmul("fc", x, w)
            g.add_node(G.Node("act", op, [h.name], {}, h.shape))
        return g, {"input": rng.standard_normal((1, 6, 6, 2))
                   .astype(np.float32)}
    return build


OP_CASES = {
    **{f"conv_k{k}_s{s}_{p}": _conv_case(k, s, p)
       for k in (1, 2, 3) for s in (1, 2) for p in ("same", "valid")},
    "conv_relu": _conv_case(3, 1, "same", "relu"),
    "conv_gelu_float64_feed": _conv_case(2, 2, "same", "gelu", np.float64),
    "matmul_4d_input": _matmul_case(None),
    "matmul_gelu": _matmul_case("gelu"),
    "add_relu": _add_relu,
    "max_pool_k2_odd": _pool_case(2, 7, 9),
    "max_pool_k3_odd": _pool_case(3, 7, 5),
    "batch_norm_flatten": _batch_norm,
    "fused_relu": _fused("relu"),
    "fused_gelu": _fused("gelu"),
    "fused_relu_fc": _fused("relu", "matmul"),
    "fused_gelu_fc": _fused("gelu", "matmul"),
}


@pytest.mark.parametrize("case", list(OP_CASES))
def test_run_node_matches_reference(case):
    tg, feeds = OP_CASES[case](TG)
    rg, _ = OP_CASES[case](RG)
    _assert_matches_reference(tg, rg, feeds)


@pytest.mark.parametrize("case", ["fused_relu", "fused_relu_fc",
                                  "matmul_gelu"])
def test_fused_matches_unfused(case):
    """The fusion pass changes no value (``tests/test_system.py``'s fusion
    case, on an FC node too), and unfused execution matches the
    reference's."""
    tg, feeds = OP_CASES[case](TG)
    rg, _ = OP_CASES[case](RG)
    fused = tg.execute(feeds, fuse=True, device="cpu")
    unfused = _assert_matches_reference(tg, rg, feeds, fuse=False)
    assert sorted(fused) == sorted(unfused)
    for o in fused:
        np.testing.assert_allclose(fused[o].numpy(), unfused[o].numpy(),
                                   rtol=1e-6)
    assert bool(tg.fusion_plan()) == case.startswith("fused")


def test_fusion_plan_matches_reference():
    """Only relu/gelu fold, only into an activation-free conv or matmul with
    one consumer."""
    def build(G):
        rng = np.random.default_rng(6)
        with G.Graph("plan") as g:
            x = G.input_data("input", np.zeros((1, 4, 4, 2)))
            w = G.weight("w", rng.standard_normal((3, 3, 2, 2)))
            two = G.convolution("two_consumers", x, w)
            G.relu("r1", two)
            G.relu("r2", two)
            act = G.convolution("has_activation", x, w, activation="relu")
            G.relu("r3", act)
            G.relu("r4", G.add("add", x, x))
            G.relu("r5", G.convolution("folds", x, w))
        return g
    assert build(TG).fusion_plan() == build(RG).fusion_plan() == \
        {"r5": "folds"}


def test_unknown_and_unfused_gelu_nodes_raise_as_reference():
    """A ``gelu`` node runs only folded into its producer: unfused, both
    packages refuse it as an unknown op."""
    tg, feeds = _fused("gelu")(TG)
    rg, _ = _fused("gelu")(RG)
    with pytest.raises(ValueError, match="unknown op gelu"):
        rg.execute(feeds, fuse=False)
    with pytest.raises(ValueError, match="unknown op gelu"):
        tg.execute(feeds, fuse=False, device="cpu")


@pytest.mark.parametrize("k,stride", [(1, 1), (2, 1), (3, 1), (2, 2), (3, 2),
                                      (4, 3)])
def test_same_padding_matches_lax(k, stride):
    """SAME pads as ``lax.conv_general_dilated``: lo = total // 2, the odd
    one high (a 2x2 kernel pads (0, 1)); ``F.unfold``'s symmetric padding
    would not."""
    import jax
    for size in (5, 6, 7, 16):
        (expect,) = jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")
        assert TGO._same_pads(size, k, stride) == tuple(expect)


def test_im2col_orders_k_as_hwio():
    """Patches in (kh, kw, cin) order: a product with the HWIO weight
    reshaped to (kh kw cin, cout) is the convolution."""
    x = torch.arange(2 * 4 * 5 * 3, dtype=torch.float32).reshape(2, 4, 5, 3)
    a, (n, oh, ow) = TGO.im2col(x, 2, 3, 1, "valid")
    assert (n, oh, ow) == (2, 3, 3) and a.shape == (18, 18)
    np.testing.assert_array_equal(a[0].numpy(),
                                  x[0, 0:2, 0:3].reshape(-1).numpy())


# -- the paper's networks ----------------------------------------------------

@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("net", list(PAPER_NETS))
def test_paper_net_matches_reference(net, batch):
    """Each Table-III net (``tests/test_system.py``'s paper-nets case on all
    five, at batch 1 and 2): node by node, and the logits, against the
    reference ``Graph.execute``."""
    tg = build_paper_graph(PAPER_NETS[net], batch=batch)
    rg = ref_build(REF_NETS[net], batch=batch)
    feeds = {"input": np.random.default_rng(7).standard_normal(
        (batch, *PAPER_NETS[net].input_shape)).astype(np.float32)}
    out = _assert_matches_reference(tg, rg, feeds)
    (final,) = out.values()
    assert final.shape == (batch, PAPER_NETS[net].n_classes)
    assert torch.isfinite(final).all()


@pytest.mark.parametrize("net", list(PAPER_NETS))
def test_build_paper_graph_params_equal_reference(net):
    """Same rng calls in the same order: the params of one seed are the
    reference's bit for bit, and so are the nodes; another seed differs."""
    default = build_paper_graph(PAPER_NETS[net])
    _same_structure(default, ref_build(REF_NETS[net]))
    seeded = build_paper_graph(PAPER_NETS[net], batch=3,
                               rng=np.random.default_rng(11))
    _same_structure(seeded, ref_build(REF_NETS[net], batch=3,
                                      rng=np.random.default_rng(11)))
    assert not np.array_equal(seeded.params["w_out"],
                              default.params["w_out"])


def _matmul_shapes(g):
    """(M, N, K) of each conv and FC node's product, from node shapes."""
    shapes = []
    for n in (g.nodes[k] for k in g.order):
        if n.op in ("convolution", "matmul"):
            x = g.nodes[n.inputs[0]].shape
            m = int(np.prod(n.shape[:-1])) if n.op == "convolution" else x[0]
            shapes.append((m, n.shape[-1], _k(g, n)))
    return shapes


@pytest.mark.parametrize("net", list(PAPER_NETS))
def test_graph_path_matmul_variants(net):
    """The products a forward hands the matmul: their operands have the
    shapes of the nodes, and the float32 rule takes ``tf32x3`` and
    ``stream`` as often as ``LAUNCHES`` says (``chip_smoke.py`` asserts the
    same counts on the card)."""
    for batch, expect in LAUNCHES[net].items():
        shapes = _matmul_shapes(build_paper_graph(PAPER_NETS[net], batch))
        rule = [mm.variant(M, N, K, torch.float32) for M, N, K in shapes]
        assert (rule.count("tf32x3"), rule.count("stream")) == expect
    g = build_paper_graph(PAPER_NETS[net], 2)
    vals = g.values({"input": np.zeros((2, *PAPER_NETS[net].input_shape))},
                    device="cpu")
    ran = []
    for n in (g.nodes[k] for k in g.order):
        if n.op in ("convolution", "matmul"):
            a, b, _ = TGO.matmul_operands(n, vals)
            ran.append((a.shape[0], b.shape[1], a.shape[1]))
    assert ran == _matmul_shapes(g)


# -- serialization -----------------------------------------------------------

def test_graph_serialize_execute_roundtrip(tmp_path):
    """``tests/test_system.py``'s round trip on the port, and the same
    graph's outputs against the reference's."""
    def build(G):
        rng = np.random.default_rng(0)
        with G.Graph(name="lenet-ish", backend="mxu") as g:
            x = G.input_data("input", rng.standard_normal((1, 8, 8, 1)))
            w0 = G.weight("w0", rng.standard_normal((3, 3, 1, 4)) * 0.3)
            h = G.convolution("conv0", x, w0, stride=1, padding="same",
                              activation="relu")
            h = G.max_pool("pool", h, 2)
            h = G.flatten("flat", h)
            wf = G.weight("wf", rng.standard_normal((4 * 4 * 4, 10)) * 0.1)
            G.matmul("fc", h, wf)
        return g, {"input": rng.standard_normal((1, 8, 8, 1))
                   .astype(np.float32)}
    g, feed = build(TG)
    g.write_graph(str(tmp_path / "net"))
    g2 = TG.Graph.read_graph(str(tmp_path / "net"))
    o1 = g.execute(feed, device="cpu")
    o2 = g2.execute(feed, device="cpu")
    np.testing.assert_allclose(o1["fc"].numpy(), o2["fc"].numpy(), rtol=1e-5)
    assert o1["fc"].shape == (1, 10)
    _assert_matches_reference(g2, build(RG)[0], feed)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_graph_files_cross_packages(tmp_path, writer):
    """A graph one package writes (JSON topology + npz params), the other
    reads: the same nodes and params, and the same outputs."""
    net = "cnn10"
    path = str(tmp_path / net)
    if writer == "reference":
        ref_build(REF_NETS[net], batch=2).write_graph(path)
    else:
        build_paper_graph(PAPER_NETS[net], batch=2).write_graph(path)
    tg, rg = TG.Graph.read_graph(path), RG.Graph.read_graph(path)
    _same_structure(tg, build_paper_graph(PAPER_NETS[net], batch=2))
    feeds = {"input": np.random.default_rng(8).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)}
    _assert_matches_reference(tg, rg, feeds)


# -- devices -----------------------------------------------------------------

def test_execute_runs_on_the_card_by_default(monkeypatch):
    """No device named: the card, and without one a refusal rather than the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = build_paper_graph(PAPER_NETS["minerva"])
    feeds = {"input": np.zeros((1, 28, 28, 1), np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        g.execute(feeds)
    assert g.execute(feeds, device="cpu")["logits"].device.type == "cpu"


def test_params_go_to_the_device_once():
    """A weight's tensor is reused across runs, and copied again only when
    its array in ``params`` is replaced."""
    g = build_paper_graph(PAPER_NETS["minerva"])
    feeds = {"input": np.ones((1, 28, 28, 1))}
    first = g.values(feeds, device="cpu")
    again = g.values(feeds, device="cpu")
    assert again["w_out"] is first["w_out"]
    g.params["w_out"] = 2 * g.params["w_out"]
    swapped = g.values(feeds, device="cpu")
    assert swapped["w_out"] is not first["w_out"]
    np.testing.assert_allclose(swapped["logits"].numpy(),
                               2 * first["logits"].numpy(), rtol=1e-6)
