"""The Mamba1 mixer's coefficients, ``kernels.ops.conv1d_silu`` and
``kernels.ops.dt_softplus``, on the CPU.

On the CPU ``ops`` runs the plain versions, which are the chain
``models.ssm`` ran in plain torch before the kernels, op for op: held here
bit for bit against that chain, written out below, at falcon_mamba_7b's
SMOKE width (d_inner 128) and at ragged widths and lengths, x read from the
``in_proj`` product as the mixer reads it.  The kernel wrappers refuse
other types, shapes and conv widths, and CPU tensors, with no launch.  The
card's path (``ops``' autograd functions) is taken here with the kernels
replaced by the plain versions: gradients and ``mamba1_forward``'s outputs
and state equal the CPU path's.  ``tests/test_torch_gpu.py`` holds the
kernels against the plain versions on the card.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.kernels import mamba_coeffs as mc
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops, ref
from repro_torch.models import ssm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMOKE_D_IN = 128     # falcon_mamba_7b SMOKE: expand 2 x d_model 64
WIDTHS = [SMOKE_D_IN, 40, 37]
LENGTHS = [1, 3, 5]


def _old_conv_silu(x, w, b):
    """The chain as ``models.ssm`` ran it: the conv as a sum of shifts, the
    bias, ``F.silu``, then x's float32 widening."""
    k, S = w.shape[1], x.shape[1]
    out = x * w[None, None, :, -1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[None, None, :, -1 - i]
    y = F.silu(out + b[None, None])
    return y, y.float()


def _old_dt(p, bias):
    return F.softplus(p.float() + bias)


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(scale * rng.standard_normal(shape)
                            .astype(np.float32)).to(torch.bfloat16)


def _conv_inputs(seed, b, S, d, k=4):
    """x as the mixer reads it, the first d columns of a (b, S, 2d) bf16
    product; w (d, k) and the bias, bf16."""
    rng = np.random.default_rng(seed)
    xz = _bf16(rng, b, S, 2 * d)
    return xz, xz[..., :d], _bf16(rng, d, k, scale=0.2), \
        _bf16(rng, d, scale=0.5)


def _dt_inputs(seed, b, S, d):
    """The dt_proj product, bf16, with values past softplus's threshold
    20 and far below 0; the float32 bias."""
    rng = np.random.default_rng(seed)
    return _bf16(rng, b, S, d, scale=12.0), torch.from_numpy(
        rng.standard_normal(d).astype(np.float32) - 4.6)


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_conv1d_silu_is_the_old_chain(d, S):
    _, x, w, b = _conv_inputs(0, 2, S, d)
    assert x.stride(1) == 2 * d
    y, yf = ops.conv1d_silu(x, w, b)
    ey, eyf = _old_conv_silu(x, w, b)
    assert y.dtype == torch.bfloat16 and yf.dtype == torch.float32
    assert torch.equal(y, ey) and torch.equal(yf, eyf)
    assert torch.equal(ref.conv1d_silu_ref(x, w, b)[0], ey)


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_dt_softplus_is_the_old_chain(d, S):
    p, bias = _dt_inputs(1, 2, S, d)
    assert (p.float() + bias).max() > 20 and (p.float() + bias).min() < -20
    out = ops.dt_softplus(p, bias)
    assert out.dtype == torch.float32
    assert torch.equal(out, _old_dt(p, bias))
    assert torch.equal(ref.dt_softplus_ref(p, bias), out)


def _conv_refusals():
    _, x, w, b = _conv_inputs(2, 1, 6, 16)
    return {
        "x float32": ((x.float(), w, b), TypeError, "bfloat16"),
        "w float16": ((x, w.half(), b), TypeError, "bfloat16"),
        "x 2-d": ((x[0], w, b), ValueError, "takes x"),
        "w of other channels": ((x, w[:8], b), ValueError, "takes x"),
        "b of other channels": ((x, w, b[:8]), ValueError, "takes x"),
        "empty x": ((x[:, :0], w, b), ValueError, "takes x"),
        "k above the maximum": ((x, torch.zeros(16, mc.K_MAX + 1,
                                                dtype=torch.bfloat16), b),
                                ValueError, "conv width"),
        "k 0": ((x, w[:, :0], b), ValueError, "conv width"),
        "on the CPU": ((x, w, b), ValueError, "CUDA"),
    }


def _dt_refusals():
    p, bias = _dt_inputs(3, 1, 6, 16)
    return {
        "p float32": ((p.float(), bias), TypeError, "bfloat16"),
        "bias bf16": ((p, bias.to(torch.bfloat16)), TypeError, "float32"),
        "bias of other channels": ((p, bias[:8]), ValueError, "takes p"),
        "empty p": ((p[:, :0], bias), ValueError, "takes p"),
        "on the CPU": ((p, bias), ValueError, "CUDA"),
    }


@pytest.mark.parametrize("case", list(_conv_refusals()))
def test_conv1d_silu_wrapper_refuses(case):
    args, err, match = _conv_refusals()[case]
    before = mc.conv1d_silu.launches
    with pytest.raises(err, match=match):
        mc.conv1d_silu(*args)
    assert mc.conv1d_silu.launches == before


@pytest.mark.parametrize("case", list(_dt_refusals()))
def test_dt_softplus_wrapper_refuses(case):
    args, err, match = _dt_refusals()[case]
    before = mc.dt_softplus.launches
    with pytest.raises(err, match=match):
        mc.dt_softplus(*args)
    assert mc.dt_softplus.launches == before


# ---------------------------------------------------------------------------
# the card's path, the kernels replaced by the plain versions


def _card_path(monkeypatch, seen):
    """``ops`` sends CPU tensors down the card's path (its autograd
    functions) with each kernel replaced by its plain version, recording
    the kernels' names as they are called."""
    def kernel(name, plain):
        def run(*args, **kw):
            assert not torch.is_grad_enabled()
            seen.append(name)
            return plain(*args, **kw)
        return run
    monkeypatch.setattr(mc, "conv1d_silu",
                        kernel("conv1d_silu", ref.conv1d_silu_ref))
    monkeypatch.setattr(mc, "dt_softplus",
                        kernel("dt_softplus", ref.dt_softplus_ref))
    monkeypatch.setattr(ms, "mamba_scan", kernel("mamba_scan",
                                                 ref.mamba_scan_ref))
    monkeypatch.setattr(ops, "_dispatch", lambda name, plain, kern, device,
                        *args, **kw: kern(*args, **kw))


def test_ops_goes_through_the_autograd_functions(monkeypatch):
    seen = []
    _card_path(monkeypatch, seen)
    xz, x, w, b = _conv_inputs(4, 2, 5, 16)
    p, bias = _dt_inputs(5, 2, 5, 16)
    xz.requires_grad_()
    p.requires_grad_()
    y, yf = ops.conv1d_silu(xz[..., :16], w, b)
    dt = ops.dt_softplus(p, bias)
    assert seen == ["conv1d_silu", "dt_softplus"]
    assert "Conv1dSilu" in type(y.grad_fn).__name__
    assert "Conv1dSilu" in type(yf.grad_fn).__name__
    assert "DtSoftplus" in type(dt.grad_fn).__name__


def _coeff_grads(xz, w, b, p, bias, dy, dyf, dout):
    """The gradients of xz (through x = its first columns), w, b, p and
    bias from ``ops``' two entry points."""
    leaves = [t.detach().clone().requires_grad_() for t in (xz, w, b, p,
                                                            bias)]
    d = w.shape[0]
    y, yf = ops.conv1d_silu(leaves[0][..., :d], *leaves[1:3])
    dt = ops.dt_softplus(*leaves[3:])
    outs = [y.detach(), yf.detach(), dt.detach()]
    return outs + list(torch.autograd.grad((y, yf, dt), leaves,
                                           (dy, dyf, dout)))


@pytest.mark.parametrize("b,S,d", [(2, 5, SMOKE_D_IN), (1, 3, 37)])
def test_card_path_gradients_equal_the_plain_versions(monkeypatch, b, S, d):
    """x, conv_w, conv_b, the dt product and dt_bias: the backward
    recomputes the plain chain, so the gradients are the CPU path's bit
    for bit."""
    xz, _, w, b_ = _conv_inputs(6, b, S, d)
    p, bias = _dt_inputs(7, b, S, d)
    rng = np.random.default_rng(8)
    dy, dout = _bf16(rng, b, S, d), torch.from_numpy(
        rng.standard_normal((b, S, d)).astype(np.float32))
    dyf = torch.from_numpy(rng.standard_normal((b, S, d)).astype(np.float32))
    args = (xz, w, b_, p, bias, dy, dyf, dout)
    expect = _coeff_grads(*args)
    _card_path(monkeypatch, [])
    got = _coeff_grads(*args)
    assert len(got) == len(expect) == 8
    for g, e in zip(got, expect):
        assert g.dtype == e.dtype and torch.equal(g, e)
    assert float(got[3].abs().sum()) > 0    # x's columns of xz


def _mixer(seed):
    cfg = configs.get_smoke_config("falcon_mamba_7b")
    gen = torch.Generator().manual_seed(seed)
    p = ssm.mamba1_init(gen, cfg)
    p["conv_b"] = (torch.randn(p["conv_b"].shape, generator=gen) * 0.1) \
        .to(torch.bfloat16)
    return cfg, p


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba1_forward_on_the_card_path_equals_the_cpu_path(monkeypatch,
                                                             with_state):
    """The mixer's output, final state and conv tail, and the gradients of
    its input and of every leaf, equal on the two paths; the card's path
    calls each kernel once."""
    cfg, p = _mixer(9)
    gen = torch.Generator().manual_seed(10)
    x_seq = torch.randn(2, 7, cfg.d_model, generator=gen).to(torch.bfloat16)
    d_in = p["in_proj"].shape[1] // 2
    state = {"ssm": torch.randn(2, d_in, cfg.ssm.d_state, generator=gen)} \
        if with_state else None
    dout = torch.randn(2, 7, cfg.d_model, generator=gen).to(torch.bfloat16)

    def run():
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in p.items()}
        xs = x_seq.clone().requires_grad_()
        out, st = ssm.mamba1_forward(leaves, xs, cfg, state=state)
        grads = torch.autograd.grad(out, [xs, *leaves.values()], dout)
        return [out.detach(), st["ssm"].detach(), st["conv"], *grads]
    expect = run()
    seen = []
    _card_path(monkeypatch, seen)
    got = run()
    assert seen == ["conv1d_silu", "dt_softplus", "mamba_scan"]
    for g, e in zip(got, expect):
        assert g.dtype == e.dtype and torch.equal(g, e)
