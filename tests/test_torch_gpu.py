"""The port's CUDA kernels on the card, held against their plain versions.

Every test here is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is False.  The file imports no JAX, so that it runs on a machine with a card
and no JAX:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.apps.paper_graphs import build_paper_graph
from repro_torch.configs import get_smoke_config
from repro_torch.configs.paper_nets import PAPER_NETS
from repro_torch.convert import to_device
from repro_torch.core import graph_ops, tree
from repro_torch.kernels import calibrate, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_coeffs as mc
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import nvdla_matmul as mm
from repro_torch.launch import camera
from repro_torch.launch.serve import serve
from repro_torch.launch.serve_batch import run_measured
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init
from repro_torch.serve.policy import StaticBatching
from repro_torch.train import TrainConfig, make_train_step

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import load_example, ulp  # noqa: E402

TOL = {"float32": (torch.float32, 1e-4),        # tests/test_kernels.py
       "bfloat16": (torch.bfloat16, 3e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", [
    (1, 2, 2, 128, 32, True, 0),              # tests/test_kernels.py
    (2, 4, 2, 128, 64, True, 0),
    (1, 2, 1, 256, 32, True, 48),
    (1, 2, 2, 128, 32, False, 0),
    (4, 4, 1, 1024, 256, True, 512),          # gemma3_1b local layer
    (4, 4, 1, 1024, 256, True, 0),            # gemma3_1b global layer
    (2, 4, 1, 1000, 256, True, 512),          # ragged S
    (1, 4, 2, 77, 96, True, 30),              # ragged S below one tile
    (1, 4, 1, 70, 16, False, 20),             # window without causal
    (2, 8, 2, 200, 128, True, 0),
    (2, 4, 4, 1000, 192, True, 0),            # MLA's q/k width: ragged S,
    (1, 4, 2, 77, 192, True, 30),             # GQA and a window,
    (1, 2, 2, 300, 192, False, 0),            # no causal mask
])
def test_cuda_kernel_matches_plain(cuda, B, H, Hkv, S, D, causal, window,
                                   dtype):
    tdt, tol = TOL[dtype]
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(cuda, tdt)
               for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    before = fa.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.dtype == tdt and out.shape == q.shape
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               expect.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(TOL))
def test_cuda_kernel_matches_plain_at_mla_prefill_shape(cuda, dtype):
    """deepseek_v2_lite_16b's prefill attention in SERVE: (4, 16, 16, 1024,
    192) causal, v zero past column 128 (MLA pads v from 128 to the q/k
    width): the Hopper variant the rule names, at the kernel tolerance, and
    the padded columns of the output exactly 0."""
    tdt, tol = TOL[dtype]
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(4, 16, 1024, 192, generator=g, device=cuda)
               .to(tdt) for _ in range(3))
    v[..., 128:] = 0
    out, ran = _launched(fa.flash_attention,
                         lambda: ops.flash_attention(q, k, v, causal=True))
    assert ran == {fa.variant(192, tdt): 1}
    expect = ref.flash_attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               expect.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    assert bool((out[..., 128:] == 0).all())


@pytest.mark.gpu
def test_cuda_kernel_takes_transposed_views(cuda):
    """gqa_forward hands the kernel (B, S, H, D) buffers seen as (B, H, S, D);
    a sliced view may also start off the kernel's 16-byte alignment."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 50, h, 32, generator=g, device=cuda)
               .bfloat16().transpose(1, 2) for h in (4, 2, 2))
    out = ops.flash_attention(q, k, v, causal=True, window=0)
    expect = ref.flash_attention_ref(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    assert (out.float() - expect.float()).abs().max().item() < 3e-2
    # a contiguous view that starts 2 bytes into its storage
    q2 = torch.randn(2 * 4 * 50 * 32 + 1, generator=g, device=cuda) \
        .bfloat16()[1:].view(2, 4, 50, 32)
    assert q2.data_ptr() % 16
    out = ops.flash_attention(q2, k, v, causal=True, window=0)
    expect = ref.flash_attention_ref(q2, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    assert (out.float() - expect.float()).abs().max().item() < 3e-2


@pytest.mark.gpu
def test_serving_on_card_matches_cpu(cuda):
    """The smoke gemma3 served on the card: every prefill goes through the
    kernel once per layer.  Then one prefill on the card and on the CPU
    (plain path) from the same params and prompts: the logits agree to bf16
    precision (2e-2, as in tests/test_torch_serve.py)."""
    cfg = get_smoke_config("gemma3_1b")
    params = T.init_params(cfg, seed=0, device="cpu")
    gpu = to_device(params, cuda)
    before = fa.flash_attention.launches
    stats = serve(cfg, requests=6, batch=4, prompt_len=20, max_new=3,
                  device=cuda, params=gpu, log=lambda *a: None)
    assert fa.flash_attention.launches - before == cfg.n_layers * 2
    assert stats["finite"] and stats["requests"] == 6
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 20)))
    cpu_logits, _ = T.prefill_forward(cfg, params, {"tokens": tokens})
    gpu_logits, _ = T.prefill_forward(cfg, gpu, {"tokens": tokens.to(cuda)})
    expect = cpu_logits.float().numpy()
    np.testing.assert_allclose(gpu_logits.float().cpu().numpy(), expect,
                               rtol=2e-2, atol=2e-2 * np.abs(expect).max())


MM_TOL = {"float32": (torch.float32, 2e-4),       # tests/test_kernels.py
          "bfloat16": (torch.bfloat16, 2e-2)}
SCAN_TOL = {"float32": (torch.float32, 2e-4),
            "bfloat16": (torch.bfloat16, 8e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(MM_TOL))
@pytest.mark.parametrize("M,N,K", [
    (128, 128, 128), (256, 128, 384),           # tests/test_kernels.py
    (512, 256, 256), (128, 512, 640),
    (100, 72, 200), (17, 130, 33), (1, 1, 1),   # ragged edges
    (3, 5, 7), (4, 6912, 1152),
    (4, 1152, 6912),                            # calibration model grid
])
def test_cuda_matmul_matches_plain(cuda, M, N, K, dtype):
    """rtol tol, atol tol * sqrt(K), as tests/test_kernels.py."""
    tdt, tol = MM_TOL[dtype]
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(cuda, tdt)
            for s in ((M, K), (K, N)))
    before = mm.matmul.launches
    out = ops.matmul(a, b)
    torch.cuda.synchronize()
    assert mm.matmul.launches == before + 1
    assert out.dtype == tdt and out.shape == (M, N)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.matmul_ref(a, b).float().cpu().numpy(),
                               rtol=tol, atol=tol * K ** 0.5)


@pytest.mark.gpu
def test_cuda_matmul_takes_views(cuda):
    """A transposed operand and one that starts off 16-byte alignment."""
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(64, 40, generator=g, device=cuda).bfloat16()
    b = torch.randn(24, 40, generator=g, device=cuda).bfloat16().t()
    a2 = torch.randn(64 * 40 + 1, generator=g, device=cuda) \
        .bfloat16()[1:].view(64, 40)
    assert a2.data_ptr() % 16
    for x in (a, a2):
        out = ops.matmul(x, b)
        expect = ref.matmul_ref(x, b)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   expect.float().cpu().numpy(), rtol=2e-2,
                                   atol=2e-2 * 40 ** 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(SCAN_TOL))
@pytest.mark.parametrize("b,S,d,N", [
    (1, 32, 16, 8), (2, 64, 32, 16), (1, 128, 64, 8),   # tests/test_kernels.py
    (1, 77, 40, 16), (3, 200, 130, 8), (1, 1, 1, 16),   # ragged S and d
    (1, 512, 8192, 16),                                 # model grid
    (1, 2048, 256, 16), (2, 2048, 130, 8),              # 2048 steps
])
def test_cuda_mamba_scan_matches_plain(cuda, b, S, d, N, dtype):
    """rtol tol, atol 4 tol, as tests/test_kernels.py; inputs as that file
    makes them (dt = softplus(z), A = -exp(0.3 z), D = 1)."""
    tdt, tol = SCAN_TOL[dtype]
    rng = np.random.default_rng(0)

    def z(*s):
        return torch.from_numpy(rng.standard_normal(s, np.float32)).to(cuda)

    x = z(b, S, d).to(tdt)
    dt = torch.nn.functional.softplus(z(b, S, d)).to(tdt)
    B, C = z(b, S, N).to(tdt), z(b, S, N).to(tdt)
    A, D = -torch.exp(0.3 * z(d, N)), torch.ones(d, device=cuda)
    before = ms.mamba_scan.launches
    out = ops.mamba_scan(x, dt, B, C, A, D)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == before + 1
    assert out.dtype == tdt and out.shape == (b, S, d)
    expect = ref.mamba_scan_ref(x, dt, B, C, A, D)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               expect.float().cpu().numpy(), rtol=tol,
                               atol=4 * tol)


def _scan_args(cuda, b, S, d, N, dtype=torch.float32, seed=0):
    """x, dt, B, C in ``dtype``, A, D as tests/test_kernels.py makes them,
    and a float32 starting state h0."""
    rng = np.random.default_rng(seed)

    def z(*s):
        return torch.from_numpy(rng.standard_normal(s, np.float32)).to(cuda)

    x = z(b, S, d).to(dtype)
    dt = torch.nn.functional.softplus(z(b, S, d)).to(dtype)
    B, C = z(b, S, N).to(dtype), z(b, S, N).to(dtype)
    return (x, dt, B, C, -torch.exp(0.3 * z(d, N)), torch.ones(d, device=cuda),
            z(b, d, N))


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", list(SCAN_TOL))
@pytest.mark.parametrize("b,S,d,N", [
    (1, 32, 16, 8), (2, 64, 32, 16), (1, 128, 64, 8),   # tests/test_kernels.py
    (1, 77, 40, 16), (3, 200, 130, 8), (2, 300, 256, 16),   # ragged S
])
def test_cuda_mamba_scan_state_matches_plain(cuda, b, S, d, N, dtype,
                                             with_h0):
    """y and the final state, from zeros or from h0, at the scan's
    tolerances (the state at the float32 one: it is float32 in both)."""
    tdt, tol = SCAN_TOL[dtype]
    *args, h0 = _scan_args(cuda, b, S, d, N, tdt)
    h0 = h0 if with_h0 else None
    before = ms.mamba_scan.launches
    y, hT = ops.mamba_scan(*args, h0=h0, return_state=True)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == before + 1
    assert hT.shape == (b, d, N) and hT.dtype == torch.float32
    ey, ehT = ref.mamba_scan_ref(*args, h0=h0, return_state=True)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ey.float().cpu().numpy(), rtol=tol,
                               atol=4 * tol)
    np.testing.assert_allclose(hT.cpu().numpy(), ehT.cpu().numpy(),
                               rtol=2e-4, atol=8e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b,S,d,N,cut", [(2, 300, 130, 16, 137),
                                         (1, 64, 64, 8, 32)])
def test_cuda_mamba_scan_split_prompt_equals_one_call(cuda, b, S, d, N, cut):
    """The kernel on the first ``cut`` steps, then on the rest from that
    final state, equals one call over the whole, bit for bit: the state
    leaves the registers and comes back unchanged, and steps past S keep
    it (x = dt = 0)."""
    x, dt, B, C, A, D, h0 = _scan_args(cuda, b, S, d, N)
    y, hT = ops.mamba_scan(x, dt, B, C, A, D, h0=h0, return_state=True)
    y1, h1 = ops.mamba_scan(x[:, :cut], dt[:, :cut], B[:, :cut], C[:, :cut],
                            A, D, h0=h0, return_state=True)
    y2, h2 = ops.mamba_scan(x[:, cut:], dt[:, cut:], B[:, cut:], C[:, cut:],
                            A, D, h0=h1, return_state=True)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert torch.equal(h2, hT)


@pytest.mark.gpu
def test_cuda_mamba_scan_refuses_a_mismatched_state(cuda):
    x, dt, B, C, A, D, h0 = _scan_args(cuda, 2, 9, 40, 16)
    before = ms.mamba_scan.launches
    for bad in (h0.cpu(), h0.double(), h0[:, :, :8], h0[0]):
        with pytest.raises(ValueError, match="h0"):
            ms.mamba_scan(x, dt, B, C, A, D, h0=bad)
    assert ms.mamba_scan.launches == before


@pytest.mark.gpu
def test_serving_falcon_mamba_on_card(cuda):
    """The SMOKE falcon_mamba_7b served on the card: every prefill runs the
    scan kernel and the two coefficient kernels once a layer.  Then one
    prefill and 2 decode steps on the card and on the CPU (plain path) from
    the same params and prompts: logits and cache agree to bf16 precision
    (2e-2, as in tests/test_torch_serve.py)."""
    cfg = get_smoke_config("falcon_mamba_7b")
    params = T.init_params(cfg, seed=0, device="cpu")
    gpu = to_device(params, cuda)
    before = (ms.mamba_scan.launches, mc.conv1d_silu.launches,
              mc.dt_softplus.launches)
    stats = serve(cfg, requests=6, batch=4, prompt_len=40, max_new=3,
                  device=cuda, params=gpu, log=lambda *a: None)
    assert (ms.mamba_scan.launches - before[0],
            mc.conv1d_silu.launches - before[1],
            mc.dt_softplus.launches - before[2]) == (cfg.n_layers * 2,) * 3
    assert stats["finite"] and stats["requests"] == 6
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 37)))
    out, toks = {}, []
    for key, dev, p in (("cpu", "cpu", params), ("card", cuda, gpu)):
        logits, cache = T.prefill_forward(cfg, p, {"tokens": tokens.to(dev)})
        steps = [logits]
        for i in range(2):   # both sides take the CPU's greedy tokens
            if key == "cpu":
                toks.append(torch.argmax(logits[:, -1], -1, keepdim=True))
            logits, cache = T.decode_forward(cfg, p, cache, toks[i].to(dev),
                                             37 + i)
            steps.append(logits)
        out[key] = [t.float().cpu().numpy()
                    for t in steps + [cache["conv"], cache["ssm"]]]
    for got, expect in zip(out["card"], out["cpu"]):
        np.testing.assert_allclose(got, expect, rtol=2e-2,
                                   atol=2e-2 * np.abs(expect).max())


@pytest.mark.gpu
def test_serve_batch_measured_on_card(cuda):
    """``serve_batch.run_measured`` at the SMOKE gemma3_1b on the card: the
    batch's prefill runs the flash kernel once a layer, all ``wgmma`` at
    head dim 16; every logit is finite and the prefill's last-position
    logits agree with the CPU run from the same params to bf16 precision
    (2e-2)."""
    cfg = get_smoke_config("gemma3_1b")
    assert cfg.resolved_head_dim == 16
    params = T.init_params(cfg, seed=0, device="cpu")
    gpu = to_device(params, cuda)
    policy = StaticBatching(max_batch=4)
    fa.reset_counts()
    out = run_measured(cfg, policy, prompt_len=40, tokens=4, device=cuda,
                       params=gpu, log=lambda *a: None)
    assert fa.flash_attention.launches == cfg.n_layers
    assert fa.flash_attention.launches_by_variant["wgmma"] == cfg.n_layers
    assert fa.variant(16, torch.bfloat16) == "wgmma"
    assert out["finite"] and out["tokens"].shape == (4, 4)
    cpu = run_measured(cfg, policy, prompt_len=40, tokens=4, device="cpu",
                       params=params, log=lambda *a: None)
    got, expect = (o["logits"].float().cpu().numpy() for o in (out, cpu))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, expect, rtol=2e-2,
                               atol=2e-2 * np.abs(expect).max())


@pytest.mark.gpu
def test_cuda_mamba_scan_refuses_other_state_dims(cuda):
    x = torch.zeros(1, 4, 8, device=cuda)
    B = torch.zeros(1, 4, 12, device=cuda)
    with pytest.raises(ValueError, match="state dim"):
        ms.mamba_scan(x, x, B, B, torch.zeros(8, 12, device=cuda),
                      torch.zeros(8, device=cuda))


# the Mamba1 mixer's coefficient kernels (kernels/mamba_coeffs.py)
COEFF_CASES = [
    (2, 512, 8192, 4),       # falcon_mamba_7b's d_inner
    (2, 300, 4096, 4),       # its shard over model 2
    (1, 77, 2048, 4),        # over model 4
    (3, 77, 40, 4),          # ragged S, d a multiple of 8
    (2, 33, 37, 4), (1, 5, 130, 4),   # d off the 16-byte vector
    (1, 1, 8, 4), (1, 3, 16, 4),      # S below the conv's width
    (1, 70, 64, 1), (1, 70, 64, 2), (1, 70, 64, 3),   # other conv widths
]
DT_CASES = sorted({case[:3] for case in COEFF_CASES})


def _conv_args(cuda, b, S, d, k, seed=0):
    """xz (b, S, 2d) bf16 and x its first d columns, as the mixer reads
    them; w (d, k) and the bias bf16."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    xz = torch.randn(b, S, 2 * d, generator=g, device=cuda).bfloat16()
    w = (0.2 * torch.randn(d, k, generator=g, device=cuda)).bfloat16()
    bias = (0.5 * torch.randn(d, generator=g, device=cuda)).bfloat16()
    return xz, xz[..., :d], w, bias


@pytest.mark.gpu
@pytest.mark.parametrize("b,S,d,k", COEFF_CASES)
def test_cuda_conv1d_silu_matches_plain(cuda, b, S, d, k):
    """Within one bf16 ulp of the chain evaluated in float32 (the kernel
    rounds once), at the bf16 tolerance of the plain bf16 chain, which
    rounds each op; yf the float32 widening of y exactly.  x read in place
    at xz's row stride, one launch."""
    _, x, w, bias = _conv_args(cuda, b, S, d, k)
    before = mc.conv1d_silu.launches
    y, yf = ops.conv1d_silu(x, w, bias)
    torch.cuda.synchronize()
    assert mc.conv1d_silu.launches == before + 1
    assert y.dtype == torch.bfloat16 and yf.dtype == torch.float32
    assert y.shape == yf.shape == (b, S, d) and y.is_contiguous()
    assert torch.equal(yf, y.float())
    e32 = ref.conv1d_silu_ref(x.float(), w.float(), bias.float())[1]
    assert bool(((y.float() - e32).abs() <= ulp(e32, 8)).all())
    ey, _ = ref.conv1d_silu_ref(x, w, bias)
    tol = TOL["bfloat16"][1]
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ey.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,S,d", DT_CASES)
def test_cuda_dt_softplus_matches_plain(cuda, b, S, d):
    """Within 2 float32 ulps of ``F.softplus(p.float() + bias)`` on the
    card, sums past the threshold 20 and far below 0 included; one
    launch."""
    g = torch.Generator(device=cuda).manual_seed(1)
    p = (12 * torch.randn(b, S, d, generator=g, device=cuda)).bfloat16()
    bias = torch.randn(d, generator=g, device=cuda) - 4.6
    before = mc.dt_softplus.launches
    out = ops.dt_softplus(p, bias)
    torch.cuda.synchronize()
    assert mc.dt_softplus.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == p.shape
    expect = ref.dt_softplus_ref(p, bias)
    assert bool(((out - expect).abs() <= 2 * ulp(expect, 24)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,S,d", [(2, 96, 256), (1, 40, 37)])
def test_cuda_coeff_functions_gradients_match_plain(cuda, b, S, d):
    """``ops.conv1d_silu`` and ``ops.dt_softplus`` on tensors that require
    grad: one launch each, and the gradients of x (through xz), w, the
    bias, the dt product and dt's bias are the plain versions', which the
    backward recomputes, bit for bit."""
    xz, _, w, bias = _conv_args(cuda, b, S, d, 4, seed=2)
    g = torch.Generator(device=cuda).manual_seed(3)
    p = torch.randn(b, S, d, generator=g, device=cuda).bfloat16()
    dt_bias = torch.randn(d, generator=g, device=cuda) - 4.6
    douts = (torch.randn(b, S, d, generator=g, device=cuda).bfloat16(),
             torch.randn(b, S, d, generator=g, device=cuda))

    def conv(fn):
        return lambda xz, w, bias: fn(xz[..., :d], w, bias)
    before = (mc.conv1d_silu.launches, mc.dt_softplus.launches)
    _, grads = _grads(conv(ops.conv1d_silu), (xz, w, bias), douts)
    _, dt_grads = _grads(ops.dt_softplus, (p, dt_bias), douts[1:])
    torch.cuda.synchronize()
    assert (mc.conv1d_silu.launches, mc.dt_softplus.launches) == \
        (before[0] + 1, before[1] + 1)
    _, expect = _grads(conv(ref.conv1d_silu_ref), (xz, w, bias), douts)
    _, dt_expect = _grads(ref.dt_softplus_ref, (p, dt_bias), douts[1:])
    for got, e in zip(grads + dt_grads, expect + dt_expect):
        assert got.dtype == e.dtype and torch.equal(got, e)


@pytest.mark.gpu
def test_cuda_coeff_wrappers_refuse(cuda):
    """Another type, a shape or a conv width the kernels do not take, and
    an input that requires grad while autograd records: no launch."""
    _, x, w, bias = _conv_args(cuda, 1, 8, 16, 4)
    p = torch.zeros(1, 8, 16, device=cuda).bfloat16()
    dt_bias = torch.zeros(16, device=cuda)
    before = (mc.conv1d_silu.launches, mc.dt_softplus.launches)
    for args, err in (((x.float(), w, bias), TypeError),
                      ((x, w[:8], bias), ValueError),
                      ((x, torch.zeros(16, mc.K_MAX + 1, device=cuda)
                        .bfloat16(), bias), ValueError),
                      ((x, w.cpu(), bias), ValueError),
                      ((x.clone().requires_grad_(), w, bias), RuntimeError)):
        with pytest.raises(err):
            mc.conv1d_silu(*args)
    for args, err in (((p.half(), dt_bias), TypeError),
                      ((p, dt_bias[:8]), ValueError),
                      ((p, dt_bias.cpu()), ValueError),
                      ((p, dt_bias.clone().requires_grad_()), RuntimeError)):
        with pytest.raises(err):
            mc.dt_softplus(*args)
    assert (mc.conv1d_silu.launches, mc.dt_softplus.launches) == before


@pytest.mark.gpu
def test_calibration_on_card(cuda):
    """The calibration loop over the reference's full grid on the card: the
    kernels ran, and the measured table reproduces every sample."""
    records, meta = calibrate.measure(grid="full", repeat=1)
    assert meta["backend"] == "cuda" and meta["interpret"] is False
    assert meta["device"] == torch.cuda.get_device_name(0)
    assert len(records) == sum(len(g) for g in calibrate.FULL_GRIDS.values())
    report = calibrate.build_report(records, meta)
    for fit in report["kernels"].values():
        assert fit["table_max_rel_err"] == 0.0


@pytest.mark.gpu
def test_calibration_times_the_card_not_the_host(cuda):
    """A call that spends 2 ms on the host before a tiny launch is timed at
    the launch's device time, far below the host's 2 ms."""
    x = torch.ones(1024, device=cuda)

    def call():
        time.sleep(2e-3)
        x.add_(1.0)

    assert calibrate._best_of(call, 3, torch.device(cuda)) < 1e-3


# head dims off whole 128-byte TMA boxes (16, 32, 96: padded boxes):
# B, H, Hkv, S, D, causal, window
SMALL_D_CASES = [
    (4, 32, 32, 1024, 96, True, 0),           # phi3_mini_3_8b prefill
    (2, 4, 2, 1000, 96, True, 0),             # ragged S, GQA
    (1, 4, 1, 50, 96, True, 0),               # S below one tile, MQA
    (2, 4, 1, 1000, 96, True, 100),           # window off the tile grid
    (1, 2, 2, 256, 96, False, 70),            # window without causal
    (2, 4, 2, 1000, 16, True, 0),
    (1, 4, 1, 77, 16, True, 30),              # S below two tiles, window
    (1, 2, 1, 300, 16, False, 0),             # no causal mask
    (1, 4, 1, 40, 16, True, 0),               # S below one tile
    (2, 4, 2, 333, 32, True, 0),              # S off 4 (padded V^T rows)
    (1, 4, 1, 1000, 32, True, 64),            # window of one tile
    (1, 2, 1, 256, 32, False, 0),
]


def _launched(fn, call):
    """What ``call()`` returned, and the launches it added by variant."""
    before = dict(fn.launches_by_variant)
    out = call()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in fn.launches_by_variant.items()
                 if n != before[k]}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", [
    (4, 4, 1, 1024, 256, True, 512),          # gemma3_1b local layer
    (4, 4, 1, 1024, 256, True, 0),            # gemma3_1b global layer
    (4, 4, 1, 1024, 64, True, 0),             # the Hopper variant's other Ds
    (4, 4, 1, 1024, 128, True, 512),
    (2, 4, 2, 1000, 128, True, 0),            # ragged S, GQA
    (1, 4, 1, 77, 256, True, 0),              # S below two tiles
    (1, 4, 1, 77, 64, True, 30),
    (2, 4, 1, 1024, 256, True, 64),           # window of one tile
    (1, 4, 1, 1000, 128, True, 100),          # window off the tile grid
    (1, 2, 1, 300, 256, False, 0),            # no causal mask
    (1, 2, 1, 256, 64, False, 70),            # window without causal
] + SMALL_D_CASES)
def test_cuda_flash_variants_match_plain(cuda, B, H, Hkv, S, D, causal,
                                         window, kernel):
    """Both bf16 variants at every head dim, at 3e-2 (tests/test_kernels.py);
    the rule names the Hopper one."""
    assert fa.variant(D, torch.bfloat16) == "wgmma"
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(cuda, torch.bfloat16)
               for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    out, ran = _launched(fa.flash_attention, lambda: fa.flash_attention(
        q, k, v, causal=causal, window=window, kernel=kernel))
    assert ran == {kernel: 1}
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               expect.float().cpu().numpy(), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["wgmma", "mma_sync"])
@pytest.mark.parametrize("M,N,K", [
    (128, 128, 128), (256, 128, 384),           # tests/test_kernels.py
    (512, 256, 256), (128, 512, 640), (100, 72, 200),
    (200, 6912, 1152), (4100, 1032, 1152),      # M, N off the Hopper tile
    (512, 1024, 4096),                          # K over many ring turns
    (4096, 1024, 1152), (1024, 6912, 1152),     # calibration model grid
])
def test_cuda_matmul_variants_match_plain(cuda, M, N, K, kernel):
    """Both bf16 variants where the Hopper one applies, at rtol 2e-2, atol
    2e-2 sqrt(K) (tests/test_kernels.py); the shape rule names the Hopper
    one."""
    assert mm.variant(M, N, K, torch.bfloat16) == "wgmma"
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    b = torch.randn(K, N, generator=g, device=cuda).bfloat16()
    out, ran = _launched(mm.matmul, lambda: mm.matmul(a, b, kernel=kernel))
    assert ran == {kernel: 1}
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.matmul_ref(a, b).float().cpu().numpy(),
                               rtol=2e-2, atol=2e-2 * K ** 0.5)


F32_TEST_SHAPES = [
    (128, 128, 128), (256, 128, 384),           # tests/test_kernels.py
    (512, 256, 256), (128, 512, 640),
    (17, 130, 33), (100, 72, 200), (4100, 1032, 1150),   # off every tile
    (512, 1024, 4096),                          # K over many ring turns
] + list(calibrate.MODEL_GRIDS["matmul"])
F32_DECODE_SHAPES = [   # M <= 16: the stream variant's rule
    (1, 1, 1), (3, 5, 7), (16, 130, 33), (5, 1150, 100), (2, 1031, 4099),
    (16, 1024, 1152), (4, 6912, 1152),
] + [s for s in calibrate.MODEL_GRIDS["matmul"] if s[0] <= mm.SMALL_M]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,M,N,K", [
    (kernel, *shape) for kernel in ("tf32x3", "fma")
    for shape in F32_TEST_SHAPES] + [
    ("stream", *shape) for shape in F32_DECODE_SHAPES])
def test_cuda_matmul_fp32_variants_match_plain(cuda, kernel, M, N, K):
    """Every float32 variant at rtol 2e-4, atol 2e-4 sqrt(K)
    (tests/test_kernels.py): three TF32 passes and the FMA kernel at test,
    ragged and model-grid shapes, the streaming kernel at decoding shapes;
    each call launches the named variant once."""
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(M, K, generator=g, device=cuda)
    b = torch.randn(K, N, generator=g, device=cuda)
    out, ran = _launched(mm.matmul, lambda: mm.matmul(a, b, kernel=kernel))
    assert ran == {kernel: 1}
    assert out.dtype == torch.float32 and out.shape == (M, N)
    np.testing.assert_allclose(out.cpu().numpy(),
                               ref.matmul_ref(a, b).cpu().numpy(),
                               rtol=2e-4, atol=2e-4 * K ** 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,M,N,K", [
    ("tf32x3", *shape) for shape in F32_TEST_SHAPES] + [
    ("stream", 4, 1152, 6912), ("fma", 4, 1152, 6912),   # split K
    ("mma_sync", 4, 1152, 6912)])
def test_cuda_matmul_refuses_a_short_workspace(cuda, kernel, M, N, K):
    """The kernel sizes its workspace as the wrapper does
    (``tf32x3_workspace`` for tf32x3) at the chooser's tile and split, and
    refuses one element less with cudaErrorInvalidValue (1), before it
    launches anything."""
    lib = mm._lib()
    code = mm.VARIANTS[kernel][0]
    dtype = mm.VARIANTS[kernel][1]
    t = mm.tiling_of(M, N, K, dtype, kernel=kernel)
    n_ws = lib.nvdla_matmul_workspace(M, N, K, code, t.splits)
    if kernel == "tf32x3":
        assert n_ws == mm.tf32x3_workspace(M, N, K, t.splits)
    assert n_ws > 0
    a = torch.zeros(M, K, device=cuda, dtype=dtype)
    b = torch.zeros(K, N, device=cuda, dtype=dtype)
    c = torch.full((M, N), 7.0, device=cuda, dtype=dtype)
    ws = torch.empty(n_ws, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for short in (n_ws - 1, 0):
        assert lib.nvdla_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                ws.data_ptr(), short, M, N, K,
                                mm._DTYPES[dtype], code, t.bm, t.bn, t.bk,
                                t.splits, stream) == 1
    torch.cuda.synchronize()
    assert bool((c == 7).all())   # nothing ran
    assert lib.nvdla_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                            ws.data_ptr(), n_ws, M, N, K, mm._DTYPES[dtype],
                            code, t.bm, t.bn, t.bk, t.splits, stream) == 0
    torch.cuda.synchronize()
    assert bool((c == 0).all())


TILE_CASES = [(name, tile) for name in mm.VARIANTS
              for tile in mm.tiles(name)]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,tile", TILE_CASES)
def test_cuda_matmul_every_tile_matches_plain(cuda, kernel, tile):
    """Each tile each variant instantiates, at a shape off every tile (the
    decoding rows' own for ``stream``), at the chooser's split of K for the
    tile and unsplit, against the plain version at tests/test_kernels.py's
    tolerances, one launch a call."""
    dtype = mm.VARIANTS[kernel][1]
    tol = dict(MM_TOL.values())[dtype]
    M, N, K = (4, 100, 3000) if kernel == "stream" else (100, 72, 3000)
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    b = torch.randn(K, N, generator=g, device=cuda).to(dtype)
    expect = ref.matmul_ref(a, b).float().cpu().numpy()
    bm, bn, bk = tile
    for splits in sorted({mm.tiling_of(M, N, K, dtype, bm=bm, bn=bn, bk=bk,
                                       kernel=kernel).splits, 1}):
        out, ran = _launched(mm.matmul, lambda: mm.matmul(
            a, b, bm=bm, bn=bn, bk=bk, splits=splits, kernel=kernel))
        assert ran == {kernel: 1}
        np.testing.assert_allclose(out.float().cpu().numpy(), expect,
                                   rtol=tol, atol=tol * K ** 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", [(64, 128, 6272), (1024, 64, 72),
                                   (1024, 8, 576), (4096, 1024, 1152),
                                   (4, 1152, 6912), (300, 200, 72)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_matmul_default_is_the_chooser_tile(cuda, M, N, K, dtype):
    """The default call runs the chooser's tile and split: bit-equal to the
    same tile passed explicitly."""
    g = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    b = torch.randn(K, N, generator=g, device=cuda).to(dtype)
    t = mm.tiling_of(M, N, K, dtype)
    out = ops.matmul(a, b)
    again = ops.matmul(a, b, bm=t.bm, bn=t.bn, bk=t.bk, splits=t.splits)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_cuda_matmul_refuses_an_uninstantiated_tile(cuda):
    """The wrapper raises before launching; the kernel's entry point itself
    returns cudaErrorInvalidValue (1) and writes nothing, for a tile it
    does not instantiate and for a split count its k ranges cannot give."""
    M = N = K = 1000
    a = torch.zeros(M, K, device=cuda)
    b = torch.zeros(K, N, device=cuda)
    before = mm.matmul.launches
    with pytest.raises(ValueError, match="instantiates"):
        mm.matmul(a, b, bm=128, bn=128, bk=128)
    assert mm.matmul.launches == before
    lib, code = mm._lib(), mm.VARIANTS["tf32x3"][0]
    c = torch.full((M, N), 7.0, device=cuda)
    n_ws = mm.tf32x3_workspace(M, N, K, 9)
    ws = torch.empty(n_ws, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for tile, splits in (((128, 128, 128), 1), ((96, 128, 32), 1),
                         ((128, 128, 32), 9), ((128, 128, 32), 0)):
        assert lib.nvdla_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                ws.data_ptr(), n_ws, M, N, K, 0, code, *tile,
                                splits, stream) == 1
    torch.cuda.synchronize()
    assert bool((c == 7).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,dtype,shape", [
    ("wgmma", torch.bfloat16, (130, 100, 64)),     # N off 8: no tensor map
    ("wgmma", torch.float32, (128, 128, 128)),
    ("fma", torch.bfloat16, (128, 128, 128)),
    ("mma_sync", torch.float32, (128, 128, 128)),
    ("tf32x3", torch.bfloat16, (128, 128, 128)),
    ("stream", torch.bfloat16, (4, 128, 128)),
    ("stream", torch.float32, (17, 128, 128)),     # M above the decoding rows
])
def test_cuda_matmul_refuses_variant_off_its_rule(cuda, kernel, dtype,
                                                  shape):
    M, N, K = shape
    a = torch.zeros(M, K, device=cuda, dtype=dtype)
    b = torch.zeros(K, N, device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="variant"):
        mm.matmul(a, b, kernel=kernel)


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim,variant", [(16, "wgmma"), (64, "wgmma"),
                                              (96, "wgmma")])
def test_serving_launches_by_variant(cuda, head_dim, variant):
    """One serve call on the smoke gemma3 (head dim 16) and on it at head
    dims 64 and 96: every prefill layer launches the variant the rule
    names."""
    cfg = dataclasses.replace(get_smoke_config("gemma3_1b"),
                              head_dim=head_dim)
    params = T.init_params(cfg, seed=0, device=cuda)
    fa.reset_counts()
    stats = serve(cfg, requests=4, batch=4, prompt_len=40, max_new=2,
                  device=cuda, params=params, log=lambda *a: None)
    assert stats["finite"]
    assert fa.flash_attention.launches_by_variant == {
        **dict.fromkeys(fa.VARIANTS, 0), variant: cfg.n_layers}


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", [
    (2, 4, 2, 128, 64, True, 0),              # tests/test_kernels.py, D = 64
    (1, 4, 1, 1024, 256, True, 0),            # calibration model grid
    (4, 4, 1, 1024, 128, True, 512),
    (1, 4, 1, 1000, 128, True, 0),            # ragged S
    (2, 4, 1, 1000, 256, True, 512),          # ragged S, window
    (2, 4, 1, 1024, 256, True, 64),           # window of one tile
    (1, 4, 1, 77, 64, True, 30),              # S below two tiles
    (1, 2, 1, 300, 256, False, 0),            # no causal mask
    (1, 2, 1, 256, 64, False, 70),            # window without causal
    (2, 4, 2, 333, 128, True, 0),             # GQA, S off 4 (padded V^T)
    (2, 4, 2, 333, 192, True, 0),             # MLA's q/k width
    (1, 4, 1, 1000, 192, True, 100),          # window off the tile grid
])
def test_cuda_flash_tf32x3_matches_plain(cuda, B, H, Hkv, S, D, causal,
                                         window):
    """Three TF32 passes at the float32 tolerance, rtol = atol = 1e-4
    (tests/test_kernels.py); the shape rule names tf32x3 at these head
    dims, and one call launches it once."""
    assert fa.variant(D, torch.float32) == "tf32x3"
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(cuda)
               for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    out, ran = _launched(fa.flash_attention, lambda: fa.flash_attention(
        q, k, v, causal=causal, window=window))
    assert ran == {"tf32x3": 1}
    assert out.dtype == torch.float32 and out.shape == q.shape
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out.cpu().numpy(), expect.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["tf32x3", "fma"])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", SMALL_D_CASES)
def test_cuda_flash_fp32_variants_match_plain(cuda, B, H, Hkv, S, D, causal,
                                              window, kernel):
    """Both float32 variants at the head dims off whole TMA boxes, at
    rtol = atol = 1e-4 (tests/test_kernels.py); the rule names tf32x3."""
    assert fa.variant(D, torch.float32) == "tf32x3"
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(cuda)
               for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    out, ran = _launched(fa.flash_attention, lambda: fa.flash_attention(
        q, k, v, causal=causal, window=window, kernel=kernel))
    assert ran == {kernel: 1}
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out.cpu().numpy(), expect.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,D,expect", [
    (2, 4, 2, 128, 64, 2 * 128 * 64 * 2 * 6 + 2 * 2 * 2 * 64 * 128),
    (1, 4, 1, 1000, 256, 2 * 1000 * 256 * 5 + 2 * 256 * 1000),
    (2, 4, 2, 333, 128, 2 * 333 * 128 * 2 * 6 + 2 * 2 * 2 * 128 * 336),
    (1, 4, 1, 1000, 16, 2 * 1000 * 16 * 5 + 2 * 16 * 1000),
    (2, 4, 2, 333, 96, 2 * 333 * 96 * 2 * 6 + 2 * 2 * 2 * 96 * 336),
    (1, 4, 4, 77, 192, 2 * 77 * 192 * 8 + 2 * 4 * 192 * 80),
    (2, 4, 2, 333, 80, 2 * 333 * 80 * 2 * 6 + 2 * 2 * 2 * 80 * 336)])
def test_cuda_flash_tf32x3_refuses_a_short_workspace(cuda, B, H, Hkv, S, D,
                                                     expect):
    """The kernel sizes its workspace as q, k hi/lo and v transposed hi/lo
    with rows padded to a multiple of 4 (the counts of
    ``tests/test_torch_flash_attention.py``) and refuses one element less
    with cudaErrorInvalidValue (1), before it launches anything."""
    lib = fa._lib()
    n_ws = lib.flash_attention_workspace(B, H, Hkv, S, D)
    assert n_ws == expect
    q = torch.zeros(B, H, S, D, device=cuda)
    k = torch.zeros(B, Hkv, S, D, device=cuda)
    o = torch.full_like(q, 7.0)
    ws = torch.empty(n_ws, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    code = fa.VARIANTS["tf32x3"][0]

    def call(n):
        return lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(),
                                       k.data_ptr(), o.data_ptr(),
                                       ws.data_ptr(), n, B, H, Hkv, S, D, 1,
                                       0, 0, code, 0, 0, stream)

    assert call(n_ws - 1) == 1 and call(0) == 1
    torch.cuda.synchronize()
    assert bool((o == 7).all())   # nothing ran
    assert call(n_ws) == 0
    torch.cuda.synchronize()
    assert bool((o == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,dtype,D", [
    ("tf32x3", torch.bfloat16, 64), ("mma_sync", torch.float32, 96),
    ("fma", torch.bfloat16, 16), ("wgmma", torch.float32, 64),
    ("mma_sync", torch.bfloat16, 192), ("fma", torch.float32, 192),
    ("mma_sync", torch.bfloat16, 80), ("fma", torch.float32, 80)])
def test_cuda_flash_refuses_variant_off_its_rule(cuda, kernel, dtype, D):
    """A variant named off its type, or at a head dim it is not built for
    (the older kernels at MLA's 192 and zamba2's 80), raises before any
    launch."""
    q = torch.zeros(1, 2, 64, D, device=cuda, dtype=dtype)
    before = dict(fa.flash_attention.launches_by_variant)
    with pytest.raises(ValueError, match="variant"):
        fa.flash_attention(q, q, q, kernel=kernel)
    assert fa.flash_attention.launches_by_variant == before


# the graph path: conv (im2col) and FC products of the Table-III nets
GRAPH_MM_SHAPES = [
    (784, 32, 9), (1024, 32, 27), (1024, 64, 27),    # K under one TF32 row
    (1024, 192, 27), (784, 32, 288), (16384, 32, 288),
    (64, 10, 512), (64, 100, 300), (65536, 64, 27),  # logits at batch 64
    (1, 10, 512), (1, 100, 300), (1, 10, 6272),      # stream, N % 4 != 0
    (1, 128, 6272), (16, 512, 4608), (4, 280, 1040),
]


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", GRAPH_MM_SHAPES)
def test_cuda_matmul_graph_shapes_match_plain(cuda, M, N, K):
    """The conv and FC shapes of the paper's nets, float32, in the variant
    the rule names, at rtol 2e-4, atol 2e-4 sqrt(K) (tests/test_kernels.py)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(M, K, generator=g, device=cuda)
    b = torch.randn(K, N, generator=g, device=cuda)
    out, ran = _launched(mm.matmul, lambda: ops.matmul(a, b))
    assert ran == {mm.variant(M, N, K, torch.float32): 1}
    assert out.dtype == torch.float32 and out.shape == (M, N)
    np.testing.assert_allclose(out.cpu().numpy(),
                               ref.matmul_ref(a, b).cpu().numpy(),
                               rtol=2e-4, atol=2e-4 * K ** 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,expect", [
    (1, {"tf32x3": 4, "stream": 2}), (64, {"tf32x3": 6})])
def test_graph_on_card_matches_cpu(cuda, batch, expect):
    """CNN10 on the card against the CPU (plain path), same params and
    input: each conv and FC node, fed the card's inputs, at the float32
    matmul tolerance; the logits at rtol 5e-4, atol 5e-4 max|CPU logits|
    (rounding compounds over the layers, and batch norm divides by a batch
    std); every product on the kernel, as the rule names it."""
    g = build_paper_graph(PAPER_NETS["cnn10"], batch)
    feeds = {"input": np.random.default_rng(0).standard_normal(
        (batch, 32, 32, 3)).astype(np.float32)}
    card, ran = _launched(mm.matmul, lambda: g.values(feeds, device=cuda))
    assert ran == expect
    cpu = g.values(feeds, device="cpu")
    for n in (g.nodes[k] for k in g.order):
        if n.op not in ("convolution", "matmul"):
            continue
        node = graph_ops.run_node(g, n, {i: card[i].cpu() for i in n.inputs},
                                  g.fusion_plan())
        K = int(np.prod(g.nodes[n.inputs[1]].shape[:-1]))
        np.testing.assert_allclose(card[n.name].cpu().numpy(), node.numpy(),
                                   rtol=2e-4, atol=2e-4 * K ** 0.5,
                                   err_msg=n.name)
    e = cpu["logits"].numpy()
    np.testing.assert_allclose(card["logits"].cpu().numpy(), e, rtol=5e-4,
                               atol=5e-4 * np.abs(e).max())


@pytest.mark.gpu
def test_camera_frame_on_card(cuda):
    """A seeded 720p frame through the ISP and CNN10 on the card against
    the CPU: the RGB frame and the DNN input at atol 1e-5, CNN10's products
    on the kernel (4 tf32x3, 2 stream)."""
    g = build_paper_graph(PAPER_NETS["cnn10"])
    raw = camera.raw_frame(0)
    out, ran = _launched(mm.matmul, lambda: camera.run_frame(raw, g, cuda))
    assert ran == {"tf32x3": 4, "stream": 2}
    cpu = camera.run_frame(raw, g, "cpu")
    for key in ("rgb", "dnn_in"):
        assert out[key].device.type == "cuda"
        np.testing.assert_allclose(out[key].cpu().numpy(),
                                   cpu[key].numpy(), rtol=0, atol=1e-5)
    e = cpu["logits"].numpy()
    np.testing.assert_allclose(out["logits"].cpu().numpy(), e, rtol=5e-4,
                               atol=5e-4 * np.abs(e).max())


@pytest.mark.gpu
def test_cnn10_priced_from_the_card_table(cuda):
    """cnn10 at batch 1 priced on one H100 from a ``quick``-grid calibration
    timed on the card: finite and positive, and the table gives each of its
    samples' measured seconds back exactly."""
    from repro_torch import sim
    records, meta = calibrate.measure(grid="quick", repeat=2)
    assert meta["backend"] == "cuda" and not meta["interpret"]
    table = calibrate.table_backend(records)
    for r in records:
        assert table.op_time(sim.CostedOp("s", flops=r["flops"],
                                          op_kind=r["kind"])) == \
            r["measured_s"]
    prog = build_paper_graph(PAPER_NETS["cnn10"], 1).program(1)
    for cfg in (sim.EngineConfig(), sim.EngineConfig(cost_backend=table)):
        res = sim.run(prog, cfg)
        assert np.isfinite(res.makespan) and res.makespan > 0


@pytest.mark.gpu
def test_costmodel_torch_backend_on_the_card(cuda):
    """The cost model's torch backend on the card matches the numpy backend
    at rtol 1e-9 (float64; only the row sum's order differs), and a model
    given no device runs there."""
    from repro_torch import sim
    from repro_torch.configs import get_config
    prog = sim.from_decode(get_config("gemma3_1b"), n_tokens=32,
                           ops_per_token=8, seq_len=1024, batch=4)
    rng = np.random.default_rng(0)
    P = np.tile(sim.CostModel(prog, backend="numpy").params0, (256, 1))
    for field in ("peak_flops", "hbm_bw"):
        P[:, sim.PARAM_FIELDS.index(field)] *= rng.uniform(1 / 64, 4, 256)
    for iface in ("hbm", "dma", "acp", "ideal"):
        cfg = sim.EngineConfig(interface=iface, host_dispatch_s=1e-6)
        on_card = sim.CostModel(prog, cfg, backend="torch")
        assert on_card.device.type == "cuda"
        np.testing.assert_allclose(
            on_card.makespans(P),
            sim.CostModel(prog, cfg, backend="numpy").makespans(P),
            rtol=1e-9, atol=0)
    auto = sim.CostModel(prog)
    assert (auto.backend, auto.device.type) == ("torch", "cuda")
    obj = auto.objective({"peak_flops": (1e12, 3e14),
                          "hbm_bw": (5e10, 1.3e13)})
    g = obj.grad(np.array([[0.3, 0.7], [0.5, 0.5]]))
    assert obj.backend == "torch" and np.isfinite(g).all()


# the moe family's smoke configs, served on the card; deepseek's with
# qk_nope 24, so that its MLA q/k width (24 + 8 = 32) is a head dim of the
# kernel (the smoke config's 16 + 8 = 24 is not)
MOE_SMOKE = {
    "granite_moe_1b_a400m": get_smoke_config("granite_moe_1b_a400m"),
    "deepseek_v2_lite_16b": dataclasses.replace(
        get_smoke_config("deepseek_v2_lite_16b"),
        mla=dataclasses.replace(get_smoke_config("deepseek_v2_lite_16b").mla,
                                qk_nope_dim=24)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(MOE_SMOKE))
def test_serving_moe_on_card_matches_cpu(cuda, arch):
    """A smoke MoE model served on the card: every prefill launches the
    flash kernel once a layer, in the variant the rule names at its head
    dim.  Then one prefill and 2 decode steps fed the CPU's greedy tokens,
    on the card and on the CPU (plain path) from the same params: logits
    and every cache at bf16 precision (2e-2, as in
    tests/test_torch_serve.py)."""
    cfg = MOE_SMOKE[arch]
    params = T.init_params(cfg, seed=0, device="cpu")
    gpu = to_device(params, cuda)
    D = (cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim if cfg.mla
         else cfg.resolved_head_dim)
    fa.reset_counts()
    stats = serve(cfg, requests=6, batch=4, prompt_len=20, max_new=3,
                  device=cuda, params=gpu, log=lambda *a: None)
    assert stats["finite"] and stats["requests"] == 6
    assert fa.flash_attention.launches_by_variant == {
        **dict.fromkeys(fa.VARIANTS, 0),
        fa.variant(D, torch.bfloat16): cfg.n_layers * 2}
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 20)))
    out, toks = {}, []
    for key, dev, p in (("cpu", "cpu", params), ("card", cuda, gpu)):
        logits, cache = T.prefill_forward(cfg, p, {"tokens": tokens.to(dev)},
                                          max_seq=22)
        steps = [logits]
        for i in range(2):   # both sides take the CPU's greedy tokens
            if key == "cpu":
                toks.append(torch.argmax(logits[:, -1], -1, keepdim=True))
            logits, cache = T.decode_forward(cfg, p, cache, toks[i].to(dev),
                                             20 + i)
            steps.append(logits)
        out[key] = [t.float().cpu().numpy()
                    for t in steps + [cache[k] for k in sorted(cache)]]
    for got, expect in zip(out["card"], out["cpu"]):
        np.testing.assert_allclose(got, expect, rtol=2e-2,
                                   atol=2e-2 * np.abs(expect).max())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(MOE_SMOKE))
def test_moe_layer_on_card_matches_cpu(cuda, arch):
    """One MoE layer on one bf16 input, card against CPU: the router's
    float32 product runs in full float32 on the card (TF32 off), so the
    expert indices are equal and the output agrees at bf16 precision."""
    from repro_torch.models import moe as M
    cfg = MOE_SMOKE[arch]
    p = M.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(4, 40, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    e = cfg.moe
    _, idx_cpu, _ = M._route(x.reshape(-1, cfg.d_model).float(),
                             p["router"], e.n_experts, e.top_k)
    _, idx_gpu, _ = M._route(x.reshape(-1, cfg.d_model).float().to(cuda),
                             p["router"].to(cuda), e.n_experts, e.top_k)
    assert torch.equal(idx_gpu.cpu(), idx_cpu)
    expect, _ = M.moe_apply(p, x, cfg)
    got, _ = M.moe_apply(to_device(p, cuda), x.to(cuda), cfg)
    expect = expect.float().numpy()
    np.testing.assert_allclose(got.float().cpu().numpy(), expect, rtol=2e-2,
                               atol=2e-2 * np.abs(expect).max())


# zamba2_2_7b's shared attention at head dim 80 (bf16: two TMA boxes of 64
# columns, the second holding columns 64-79; float32: three of 32):
# B, H, Hkv, S, D, causal, window
D80_CASES = [
    (4, 32, 32, 1024, 80, True, 0),           # zamba2_2_7b prefill
    (2, 4, 4, 1000, 80, True, 0),             # ragged S
    (1, 4, 2, 77, 80, True, 0),               # ragged S below two tiles
    (2, 4, 1, 1000, 80, True, 100),           # window off the tile grid
    (2, 4, 2, 1000, 80, True, 0),             # GQA 4 on 2
    (1, 2, 2, 300, 80, False, 0),             # no causal mask
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", D80_CASES)
def test_cuda_flash_head_dim_80_matches_plain(cuda, B, H, Hkv, S, D, causal,
                                              window, dtype):
    """The variant the rule names at D 80 (bf16 ``wgmma``, float32
    ``tf32x3``) against the plain version at the kernel tolerance
    (tests/test_kernels.py), on the whole output and on columns 64-79, the
    ones past the first TMA box, on their own."""
    tdt, tol = TOL[dtype]
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(cuda, tdt)
               for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    out, ran = _launched(fa.flash_attention, lambda: ops.flash_attention(
        q, k, v, causal=causal, window=window))
    assert ran == {fa.variant(80, tdt): 1}
    assert out.dtype == tdt and out.shape == q.shape
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    for cols in (slice(None), slice(64, 80)):
        np.testing.assert_allclose(out[..., cols].float().cpu().numpy(),
                                   expect[..., cols].float().cpu().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim", [0, 80])
def test_serving_zamba2_on_card_matches_cpu(cuda, head_dim):
    """The SMOKE zamba2_2_7b (its own head dim, 16, and 80) served on the
    card: each prefill launches the flash kernel once a superblock
    (n_layers // hybrid_attn_every), in the variant the rule names, and
    never the scan.  Then one prefill of two chunks and 2 decode steps fed
    the CPU's greedy tokens, on the card and on the CPU (plain path) from
    the same params: logits and every cache at bf16 precision (2e-2, as in
    tests/test_torch_serve.py)."""
    cfg = dataclasses.replace(get_smoke_config("zamba2_2_7b"),
                              head_dim=head_dim)
    params = T.init_params(cfg, seed=0, device="cpu")
    gpu = to_device(params, cuda)
    fa.reset_counts()
    scans = ms.mamba_scan.launches
    stats = serve(cfg, requests=6, batch=4, prompt_len=32, max_new=3,
                  device=cuda, params=gpu, log=lambda *a: None)
    assert stats["finite"] and stats["requests"] == 6
    assert fa.flash_attention.launches_by_variant == {
        **dict.fromkeys(fa.VARIANTS, 0),
        fa.variant(cfg.resolved_head_dim, torch.bfloat16):
            cfg.n_layers // cfg.hybrid_attn_every * 2}
    assert ms.mamba_scan.launches == scans
    S = 2 * cfg.ssm.chunk
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, S)))
    out, toks = {}, []
    for key, dev, p in (("cpu", "cpu", params), ("card", cuda, gpu)):
        logits, cache = T.prefill_forward(cfg, p, {"tokens": tokens.to(dev)},
                                          max_seq=S + 2)
        steps = [logits]
        for i in range(2):   # both sides take the CPU's greedy tokens
            if key == "cpu":
                toks.append(torch.argmax(logits[:, -1], -1, keepdim=True))
            logits, cache = T.decode_forward(cfg, p, cache, toks[i].to(dev),
                                             S + i)
            steps.append(logits)
        out[key] = [t.float().cpu().numpy()
                    for t in steps + [cache[k] for k in sorted(cache)]]
    for got, expect in zip(out["card"], out["cpu"]):
        np.testing.assert_allclose(got, expect, rtol=2e-2,
                                   atol=2e-2 * np.abs(expect).max())


# the encdec and vlm families' prefill attention: whisper_small's encoder
# (non-causal over 1500 frames, ragged at both the q and the k tile) and
# internvl2_26b's prefill at head dim 128, GQA 48 on 8 (1024 tokens after
# 256 patches): B, H, Hkv, S, D, causal, window
ENCDEC_VLM_CASES = [
    (2, 12, 12, 1500, 64, False, 0),          # whisper_small encoder
    (1, 48, 8, 1280, 128, True, 0),           # internvl2_26b prefill
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", ENCDEC_VLM_CASES)
def test_cuda_flash_encdec_vlm_shapes_match_plain(cuda, B, H, Hkv, S, D,
                                                  causal, window, dtype):
    """The variant the rule names (bf16 ``wgmma``, float32 ``tf32x3``) at
    the encdec and vlm families' prefill shapes, against the plain version
    at the kernel tolerance (tests/test_kernels.py)."""
    tdt, tol = TOL[dtype]
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(tdt)
               for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    out, ran = _launched(fa.flash_attention, lambda: ops.flash_attention(
        q, k, v, causal=causal, window=window))
    assert ran == {fa.variant(D, tdt): 1}
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               expect.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
def test_cuda_flash_refuses_kv_length_off_q(cuda):
    """Cross-attention's shapes (kv longer than q) are refused before any
    launch: the kernel takes one sequence length, as the Pallas kernel."""
    q = torch.zeros(1, 2, 64, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 100, 64, device=cuda, dtype=torch.bfloat16)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="must be"):
        fa.flash_attention(q, k, k, causal=False)
    assert fa.flash_attention.launches == before


# the encdec and vlm families' smoke configs, served on the card;
# internvl2_26b's at head dim 16, a head dim of the kernel (its smoke
# config's, 64 / 8 = 8, is not)
ENCDEC_VLM_SMOKE = {
    "whisper_small": get_smoke_config("whisper_small"),
    "internvl2_26b": dataclasses.replace(get_smoke_config("internvl2_26b"),
                                         head_dim=16),
}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(ENCDEC_VLM_SMOKE))
def test_serving_encdec_vlm_on_card_matches_cpu(cuda, arch):
    """A smoke whisper or InternVL2 served on the card: each prefill
    launches the flash kernel once a self-attention layer (whisper: its
    encoder's and its decoder's; cross-attention is plain torch), in the
    variant the rule names.  Then one prefill with random frames or
    patches and 2 decode steps fed the CPU's greedy tokens (InternVL2's
    after its patches), on the card and on the CPU (plain path) from the
    same params: logits and every cache at bf16 precision (2e-2, as in
    tests/test_torch_serve.py)."""
    cfg = ENCDEC_VLM_SMOKE[arch]
    params = T.init_params(cfg, seed=0, device="cpu")
    gpu = to_device(params, cuda)
    per_batch = cfg.n_layers + (cfg.encoder.n_layers if cfg.encoder else 0)
    fa.reset_counts()
    stats = serve(cfg, requests=6, batch=4, prompt_len=20, max_new=3,
                  device=cuda, params=gpu, log=lambda *a: None)
    assert stats["finite"] and stats["requests"] == 6
    assert fa.flash_attention.launches_by_variant == {
        **dict.fromkeys(fa.VARIANTS, 0),
        fa.variant(cfg.resolved_head_dim, torch.bfloat16): per_batch * 2}
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 20)))
    stub = {}
    if cfg.family == "encdec":
        stub["frames"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32))
    else:
        stub["patches"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.n_patches, cfg.d_model)).astype(np.float32))
    S = 20 + (cfg.n_patches if cfg.family == "vlm" else 0)
    out, toks = {}, []
    for key, dev, p in (("cpu", "cpu", params), ("card", cuda, gpu)):
        batch = {"tokens": tokens.to(dev),
                 **{k: t.to(dev) for k, t in stub.items()}}
        logits, cache = T.prefill_forward(cfg, p, batch, max_seq=S + 2)
        steps = [logits]
        for i in range(2):   # both sides take the CPU's greedy tokens
            if key == "cpu":
                toks.append(torch.argmax(logits[:, -1], -1, keepdim=True))
            logits, cache = T.decode_forward(cfg, p, cache, toks[i].to(dev),
                                             S + i)
            steps.append(logits)
        out[key] = [t.float().cpu().numpy()
                    for t in steps + [cache[k] for k in sorted(cache)]]
    for got, expect in zip(out["card"], out["cpu"]):
        np.testing.assert_allclose(got, expect, rtol=2e-2,
                                   atol=2e-2 * np.abs(expect).max())


# ---------------------------------------------------------------------------
# training: the kernels' autograd functions and a train step


GRAD_CASES = [
    (1, 4, 2, 128, 64, True, 0),              # GQA, tinyllama's head dim
    (1, 2, 1, 256, 32, True, 48),             # MQA + window
    (1, 2, 2, 128, 32, False, 0),             # non-causal
    (2, 4, 1, 700, 256, True, 512),           # gemma3_1b local, 2 bwd chunks
    (1, 4, 4, 300, 80, True, 0),              # zamba2's head dim
]


def _grads(fn, inputs, douts):
    ts = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    return [o.detach() for o in outs], list(
        torch.autograd.grad(outs, ts, douts[:len(outs)]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", GRAD_CASES)
def test_cuda_flash_function_gradients_match_plain(cuda, B, H, Hkv, S, D,
                                                   causal, window, dtype):
    """ops.flash_attention on tensors that require grad: the kernel runs
    the forward (one launch) and q, k, v get the plain version's gradients
    (the backward recomputes the plain chunks: float32 at 1e-4, bf16 at
    3e-2 of the largest gradient)."""
    tdt, tol = TOL[dtype]
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = [torch.randn(B, h, S, D, generator=g, device=cuda).to(tdt)
           for h in (H, Hkv, Hkv)]
    dout = torch.randn(B, H, S, D, generator=g, device=cuda).to(tdt)
    before = fa.flash_attention.launches
    (out,), grads = _grads(lambda *t: ops.flash_attention(
        *t, causal=causal, window=window), qkv, (dout,))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    (eout,), expect = _grads(lambda *t: ref.flash_attention_ref(
        *t, causal=causal, window=window), qkv, (dout,))
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               eout.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    for got, e in zip(grads, expect):
        assert got.dtype == tdt
        e = e.float().cpu().numpy()
        np.testing.assert_allclose(got.float().cpu().numpy(), e, rtol=tol,
                                   atol=tol * np.abs(e).max())


@pytest.mark.gpu
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("return_state", [False, True])
def test_cuda_scan_function_gradients_match_plain(cuda, with_h0,
                                                  return_state):
    """ops.mamba_scan on tensors that require grad: one kernel launch,
    and the gradients of x, dt, B, C, A, D (and h0) against dy (and dh_S)
    equal the plain version's at the float32 scan tolerance."""
    x, dt, B, C, A, D, h0 = _scan_args(cuda, 2, 96, 64, 16, seed=3)
    inputs = [x, dt, B, C, A, D] + ([h0] if with_h0 else [])
    gen = torch.Generator(device=cuda).manual_seed(1)
    douts = (torch.randn(x.shape, generator=gen, device=cuda),
             torch.randn(2, 64, 16, generator=gen, device=cuda))

    def call(fn):
        return lambda *t: fn(*t[:6], h0=t[6] if with_h0 else None,
                             return_state=return_state)
    before = ms.mamba_scan.launches
    outs, grads = _grads(call(ops.mamba_scan), inputs, douts)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == before + 1
    eouts, expect = _grads(call(ref.mamba_scan_ref), inputs, douts)
    for got, e in zip(outs + grads, eouts + expect):
        np.testing.assert_allclose(got.cpu().numpy(), e.cpu().numpy(),
                                   rtol=2e-4, atol=8e-4)


@pytest.mark.gpu
def test_cuda_raw_wrappers_raise_under_grad(cuda):
    """The raw wrappers refuse an input that requires grad while autograd
    records, with no launch; under no_grad they run."""
    q = torch.randn(1, 2, 64, 32, device=cuda, requires_grad=True)
    x, dt, B, C, A, D, _ = _scan_args(cuda, 1, 16, 32, 16)
    before = (fa.flash_attention.launches, ms.mamba_scan.launches)
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_attention(q, q.detach(), q.detach())
    with pytest.raises(RuntimeError, match="requires grad"):
        ms.mamba_scan(x.requires_grad_(), dt, B, C, A, D)
    assert (fa.flash_attention.launches, ms.mamba_scan.launches) == before
    with torch.no_grad():
        fa.flash_attention(q, q, q)
        ms.mamba_scan(x, dt, B, C, A, D)
    assert (fa.flash_attention.launches, ms.mamba_scan.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "gemma3_1b",
                                  "falcon_mamba_7b"])
def test_train_step_on_card_matches_cpu(cuda, arch, monkeypatch):
    """One train step of the SMOKE config (tinyllama's at head dim 16, a
    head dim of the kernel) in 2 microbatches on the card and on the CPU
    from the same params and batch: the kernel runs each attention (or
    scan) layer's forward and its recompute, twice a microbatch; loss and
    grad norm within 2e-2; every gradient leaf within 3e-2 relative L2 (the
    CPU tests' bf16 bound), so none is lost on the card; every updated
    param within 2.5 lr plus one bf16 step of its largest value (AdamW
    moves an element by about lr = 1e-3, and a gradient element near 0 can
    take either sign)."""
    from repro_torch.train import step as step_mod
    cfg = get_smoke_config(arch)
    if arch == "tinyllama_1_1b":
        cfg = dataclasses.replace(cfg, head_dim=16)
    params = T.init_params(cfg, seed=0, device="cpu")
    gpu = to_device(params, cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    captured = []
    clip = step_mod.clip_by_global_norm

    def capture(grads, max_norm):
        # copies: the clip scales the grads in place
        captured.append([g.detach().float().cpu().clone() for g in grads])
        return clip(grads, max_norm)
    monkeypatch.setattr(step_mod, "clip_by_global_norm", capture)
    step = make_train_step(cfg, TrainConfig(lr=1e-3, warmup=1,
                                            n_microbatches=2))
    count = (lambda: ms.mamba_scan.launches) if cfg.family == "ssm" \
        else (lambda: fa.flash_attention.launches)
    before = count()
    _, _, m_gpu = step(gpu, adamw_init(gpu),
                       {k: v.to(cuda) for k, v in batch.items()}, 1)
    torch.cuda.synchronize()
    assert count() - before == 2 * 2 * cfg.n_layers
    _, _, m_cpu = step(params, adamw_init(params), batch, 1)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m_gpu[key]), float(m_cpu[key]),
                                   rtol=2e-2)
    for g, e in zip(*captured):
        assert float((g - e).norm() / e.norm().clamp(min=1e-30)) <= 3e-2
    for a, b in zip(tree.leaves(gpu), tree.leaves(params)):
        b = b.detach().float().numpy()
        np.testing.assert_allclose(a.detach().float().cpu().numpy(), b,
                                   rtol=0,
                                   atol=2.5e-3 + 2 ** -8 * np.abs(b).max())


# ---------------------------------------------------------------------------
# the NCCL path at world size 1 (chip_smoke.py's phase 47)


@pytest.fixture
def nccl_mesh(cuda):
    """A (1, 1) mesh on a world-1 NCCL group of this process (started by
    ``make_host_mesh``), the group destroyed after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    assert not dist.is_initialized()
    mesh = make_host_mesh(1, 1, device_type="cuda")
    yield mesh
    dist.destroy_process_group()


def _smoke_card_cfg():
    return dataclasses.replace(get_smoke_config("tinyllama_1_1b"),
                               head_dim=16)


@pytest.mark.gpu
def test_smoke_train_on_a_world1_nccl_mesh_matches_no_mesh(nccl_mesh):
    """``launch.train``'s smoke path with the mesh and ``rules_for``'s
    rules installed gives the no-mesh run's losses and params bit for bit
    (a (1, 1) mesh skips every collective), 2 flash launches a layer a
    step each way."""
    import torch.distributed as dist
    from repro_torch.core.config import SHAPE_BY_NAME
    from repro_torch.launch import train as tlaunch
    assert dist.get_backend() == "nccl"
    cfg = _smoke_card_cfg()
    kw = dict(batch=4, seq=64, steps=3, device="cuda", log=lambda *a: None)
    runs = []
    for mesh in (None, nccl_mesh):
        before = fa.flash_attention.launches
        with tlaunch.installed(mesh, cfg, SHAPE_BY_NAME["train_4k"]):
            runs.append(tlaunch.train(cfg, **kw))
        torch.cuda.synchronize()
        assert fa.flash_attention.launches - before == 2 * cfg.n_layers * 3
    assert runs[0]["losses"] == runs[1]["losses"]
    for a, b in zip(tree.leaves(runs[0]["params"]),
                    tree.leaves(runs[1]["params"])):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_nccl_groups_of_the_world1_mesh_run(nccl_mesh):
    """A raw all_reduce and broadcast over each mesh dimension's NCCL group
    leave a world-1 tensor as it was: the port's own collectives skip a
    dimension of size 1, so these are what reaches NCCL at world 1."""
    import torch.distributed as dist
    for name in nccl_mesh.mesh_dim_names:
        group = nccl_mesh.get_group(name)
        x = torch.arange(4096, dtype=torch.float32, device="cuda")
        y = x.clone()
        dist.all_reduce(y, group=group)
        dist.broadcast(y, src=0, group=group)
        torch.cuda.synchronize()
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_one_stage_pipeline_on_nccl_matches_sequential(nccl_mesh):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.pipeline import pipeline_apply
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    gen = torch.Generator(device="cuda").manual_seed(4)
    w = torch.randn(256, 256, generator=gen, device="cuda") / 16
    x = torch.randn(32, 256, generator=gen, device="cuda")
    got = pipeline_apply(mesh, lambda w, h: torch.tanh(h @ w), w, x, 4)
    torch.testing.assert_close(got, torch.tanh(x @ w), rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_checkpoint_restores_onto_the_nccl_mesh(nccl_mesh, tmp_path):
    """Params saved from the card restore onto the mesh with the rules'
    placements (DTensor leaves on the card), and a checkpoint of those
    leaves reloads equal."""
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.core.config import SHAPE_BY_NAME
    from repro_torch.dist.sharding import rules_for
    cfg = _smoke_card_cfg()
    params = T.init_params(cfg, seed=0, device="cuda")
    sh = rules_for(cfg, SHAPE_BY_NAME["train_4k"], nccl_mesh).tree_shardings(
        T.param_axes(cfg), params)
    save_checkpoint(str(tmp_path), 1, params)
    out = load_checkpoint(str(tmp_path), template=params, shardings=sh,
                          mesh=nccl_mesh)["tree"]
    save_checkpoint(str(tmp_path), 2, out)
    again = load_checkpoint(str(tmp_path), template=params)["tree"]
    for a, b, c in zip(tree.leaves(out), tree.leaves(again),
                       tree.leaves(params)):
        assert isinstance(a, DTensor) and a.device.type == "cuda"
        assert torch.equal(a.to_local(), c) and torch.equal(b, c)


@pytest.mark.gpu
def test_multi_pod_raises_on_one_card(nccl_mesh):
    from repro_torch.launch import train as tlaunch
    with pytest.raises(RuntimeError, match="need 512 devices, have 1"):
        tlaunch.main(["--multi-pod"])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "falcon_mamba_7b"])
def test_tp_train_step_on_card_matches_one_process(cuda, arch, tmp_path):
    """The train step over a (data 1, model 2) mesh of two gloo ranks on
    the card, ``arch`` cut to 2 layers at full width, 2 x 512 tokens, bf16,
    against one process's step on the card: the metrics at 2e-2, every
    leaf's gradient, m and sqrt(v) shard at 3e-2 relative L2, each updated
    param within one bf16 step of AdamW's step from the rank's own m and v
    and within 2.5 lr plus one bf16 step of one process's
    (``chip_smoke.py`` phase 49a at 4 layers).  The flash kernel (D 64, 16 query heads on 2 KV heads a
    rank) or the scan (4096 of 8192 channels a rank) runs twice a layer."""
    import _torch_dist
    out = _torch_dist.spawn(_torch_dist.rank_tp_card, 2, tmp_path, arch, 2,
                            2, 512, timeout=600)
    ranks = [o[0] for o in out]
    single = out[0][1][torch.bfloat16]
    _torch_dist.assert_tp_matches(ranks, single, torch.bfloat16, 2, 2e-2,
                                  3e-2)
    expect = (0, 4) if arch == "falcon_mamba_7b" else (4, 0)
    assert all(o[2] == expect for o in out), [o[2] for o in out]


# ---------------------------------------------------------------------------
# the port's examples (examples_torch/, loaded by path)


@pytest.mark.gpu
def test_quickstart_example_on_card_matches_cpu(cuda, tmp_path):
    """``examples_torch/quickstart.py`` on the card against the same script
    on the CPU: both convolutions on the kernel (two ``tf32x3`` launches an
    execute), each fed the card's inputs at the float32 matmul tolerance,
    the unit's output at rtol 5e-4, atol 5e-4 max|CPU|."""
    qs = load_example("quickstart")
    out, ran = _launched(mm.matmul,
                         lambda: qs.main(["--out", str(tmp_path / "card")]))
    assert ran == {"tf32x3": 2}
    g = out["graph"]
    card, ran = _launched(mm.matmul,
                          lambda: g.values(qs.feeds(), device=cuda))
    assert ran == {"tf32x3": 2}
    plan = g.fusion_plan()
    for name in ("conv0", "conv1"):
        n = g.nodes[name]
        node = graph_ops.run_node(g, n, {i: card[i].cpu() for i in n.inputs},
                                  plan)
        K = int(np.prod(g.nodes[n.inputs[1]].shape[:-1]))
        np.testing.assert_allclose(card[name].cpu().numpy(), node.numpy(),
                                   rtol=2e-4, atol=2e-4 * K ** 0.5,
                                   err_msg=name)
    cpu = qs.main(["--device", "cpu", "--out", str(tmp_path / "cpu")])
    e = cpu["outputs"]["add"].numpy()
    np.testing.assert_allclose(out["outputs"]["add"].cpu().numpy(), e,
                               rtol=5e-4, atol=5e-4 * np.abs(e).max())


@pytest.mark.gpu
def test_train_lm_example_step_on_card_matches_cpu(cuda, monkeypatch):
    """Two steps of ``examples_torch/train_lm.py``'s ``cpu-small`` preset
    (head dim 32) through its ``run``, at steps 20-21 past the warmup (lr
    near its peak), on the card and on the CPU from the same params and
    batches: flash runs each layer's forward and its recompute; each step's
    lr the CPU's, loss and grad norm within 2e-2, every gradient leaf within
    3e-2 relative L2 (``test_train_step_on_card_matches_cpu``'s bounds);
    every param within 2.5 times the lrs used, summed, plus one bf16 step of
    its largest value; and the params' move over the two steps within 0.25
    of the CPU's move, in L2 over every leaf (a skipped update is 1)."""
    from repro_torch.data import synthetic_batch
    from repro_torch.train import step as step_mod
    tl = load_example("train_lm")
    cfg = tl.preset_config("tinyllama_1_1b", "cpu-small")
    tc = TrainConfig(lr=1e-3, warmup=20, total_steps=100)
    params = T.init_params(cfg, seed=0, device="cpu")
    before = [p.detach().float().clone() for p in tree.leaves(params)]
    gpu = to_device(params, cuda)
    batches = [synthetic_batch(cfg, 4, 128, np.random.default_rng(i))
               for i in (20, 21)]
    captured = []
    clip = step_mod.clip_by_global_norm

    def capture(grads, max_norm):
        captured.append([g.detach().float().cpu().clone() for g in grads])
        return clip(grads, max_norm)
    monkeypatch.setattr(step_mod, "clip_by_global_norm", capture)
    launched = fa.flash_attention.launches
    card = tl.run(cfg, tc, gpu, adamw_init(gpu), batches, 20, 22,
                  log=lambda s: None)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - launched == 4 * cfg.n_layers
    cpu = tl.run(cfg, tc, params, adamw_init(params), batches, 20, 22,
                 log=lambda s: None)
    assert min(cpu["lrs"]) > 0.99e-3 and card["lrs"] == cpu["lrs"]
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=2e-2)
    np.testing.assert_allclose(card["gnorms"], cpu["gnorms"], rtol=2e-2)
    for step in (0, 1):
        for g, e in zip(captured[step], captured[2 + step]):
            assert float((g - e).norm() / e.norm().clamp(min=1e-30)) <= 3e-2
    bound = 2.5 * sum(cpu["lrs"])
    parted, moved = 0.0, 0.0
    for a, b, b0 in zip(tree.leaves(card["params"]),
                        tree.leaves(cpu["params"]), before):
        a, b = a.detach().float().cpu(), b.detach().float()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=bound + 2 ** -8 * b.abs().max().item())
        parted += float(((a - b0) - (b - b0)).pow(2).sum())
        moved += float((b - b0).pow(2).sum())
    assert moved > 0 and parted <= 0.25 ** 2 * moved, (parted, moved)


# ---------------------------------------------------------------------------
# the kernels' block shapes from the caller

FLASH_TILES = [(name, D, tile) for name in ("wgmma", "tf32x3")
               for D in fa.HEAD_DIMS for tile in fa.tiles(name, D)]
FLASH_DTYPE = {"wgmma": "bfloat16", "tf32x3": "float32"}


@pytest.mark.gpu
@pytest.mark.parametrize("name,D,tile", FLASH_TILES)
def test_cuda_flash_every_tile_matches_plain(cuda, name, D, tile):
    """Every tile of both Hopper variants, at ragged S with GQA, S below one
    tile, a window edge off the tile grid and no causal mask, at
    tests/test_kernels.py's tolerance, each call one launch of its
    variant; the library's instance has ``tile_of``'s layout."""
    tdt, tol = TOL[FLASH_DTYPE[name]]
    rng = np.random.default_rng(1)
    for B, H, Hkv, S, causal, window in ((1, 4, 2, 100, True, 0),
                                         (1, 2, 1, 40, True, 0),
                                         (1, 4, 1, 300, True, 70),
                                         (1, 2, 2, 100, False, 0)):
        q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
                   .to(cuda, tdt)
                   for s in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
        before = dict(fa.flash_attention.launches_by_variant)
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  bq=tile[0], bk=tile[1])
        torch.cuda.synchronize()
        assert fa.flash_attention.launches_by_variant[name] \
            == before[name] + 1
        expect = ref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window)
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   expect.float().cpu().numpy(), rtol=tol,
                                   atol=tol)
    t = fa.tile_of(D, tdt, bq=tile[0], bk=tile[1])
    got = fa.instance(name, D, *tile)
    assert (got["stages"], got["smem_bytes"], got["threads"]) == \
        (t.stages, t.smem_bytes, t.threads)


@pytest.mark.gpu
@pytest.mark.parametrize("name,D,tile", [
    ("wgmma", 64, (256, 256)), ("wgmma", 64, (64, 48)),
    ("tf32x3", 256, (128, 64)), ("tf32x3", 128, (128, 128)),
    ("mma_sync", 64, (128, 64)), ("fma", 256, (64, 64))])
def test_cuda_flash_library_refuses_a_tile_it_lacks(cuda, name, D, tile):
    """cudaErrorInvalidValue (1) from the C entry itself, before a launch,
    and no instance; the wrapper raises ValueError first."""
    dtype = fa.VARIANTS[name][1]
    q, o = (torch.zeros(1, 2, 64, D, dtype=dtype, device=cuda)
            for _ in range(2))
    k = v = torch.zeros(1, 1, 64, D, dtype=dtype, device=cuda)
    lib = fa._lib()
    n_ws = lib.flash_attention_workspace(1, 2, 1, 64, D)
    ws = torch.empty(n_ws, device=cuda)
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        ws.data_ptr(), n_ws, 1, 2, 1, 64, D, 1, 0,
        0 if dtype == torch.float32 else 1, fa.VARIANTS[name][0], *tile,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 1 and fa.instance(name, D, *tile) is None
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, bq=tile[0], bk=tile[1], kernel=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(SCAN_TOL))
@pytest.mark.parametrize("tile", ms.tiles())
def test_cuda_mamba_scan_every_tile_matches_plain(cuda, tile, dtype):
    """Every (bd, chunk) at S 77, d 40 with h0 in and h_S out, at both N;
    tiles the library lacks return cudaErrorInvalidValue."""
    tdt, tol = SCAN_TOL[dtype]
    for N in ms.STATE_DIMS:
        *args, h0 = _scan_args(cuda, 2, 77, 40, N, tdt, seed=3)
        before = ms.mamba_scan.launches
        y, h = ops.mamba_scan(*args, h0=h0, return_state=True, bd=tile[0],
                              chunk=tile[1])
        torch.cuda.synchronize()
        assert ms.mamba_scan.launches == before + 1
        y_ref, h_ref = ref.mamba_scan_ref(*args, h0=h0, return_state=True)
        for got, expect in ((y, y_ref), (h, h_ref)):
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       expect.float().cpu().numpy(),
                                       rtol=tol, atol=4 * tol)
        assert ms.instance(tdt, N, *tile)["local_bytes"] >= 0
    assert ms.instance(tdt, 16, 48, 16) is None
    assert ms.instance(tdt, 16, tile[0], 0) is None
