"""The port's CUDA kernels on the card, held against their plain versions.

Every test here is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is False.  The file imports no JAX, so that it runs on a machine with a card
and no JAX:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.apps.paper_graphs import build_paper_graph
from repro_torch.configs import get_smoke_config
from repro_torch.configs.paper_nets import PAPER_NETS
from repro_torch.convert import to_device
from repro_torch.core import graph_ops
from repro_torch.kernels import calibrate, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import nvdla_matmul as mm
from repro_torch.launch import camera
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as T

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
    scan kernel once a layer.  Then one prefill and 2 decode steps on the
    card and on the CPU (plain path) from the same params and prompts:
    logits and cache agree to bf16 precision (2e-2, as in
    tests/test_torch_serve.py)."""
    cfg = get_smoke_config("falcon_mamba_7b")
    params = T.init_params(cfg, seed=0, device="cpu")
    gpu = to_device(params, cuda)
    before = ms.mamba_scan.launches
    stats = serve(cfg, requests=6, batch=4, prompt_len=40, max_new=3,
                  device=cuda, params=gpu, log=lambda *a: None)
    assert ms.mamba_scan.launches - before == cfg.n_layers * 2
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
def test_cuda_mamba_scan_refuses_other_state_dims(cuda):
    x = torch.zeros(1, 4, 8, device=cuda)
    B = torch.zeros(1, 4, 12, device=cuda)
    with pytest.raises(ValueError, match="state dim"):
        ms.mamba_scan(x, x, B, B, torch.zeros(8, 12, device=cuda),
                      torch.zeros(8, device=cuda))


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
    (``tf32x3_workspace`` for tf32x3) and refuses one element less with
    cudaErrorInvalidValue (1), before it launches anything."""
    lib = mm._lib()
    code = mm.VARIANTS[kernel][0]
    dtype = mm.VARIANTS[kernel][1]
    n_ws = lib.nvdla_matmul_workspace(M, N, K, code)
    if kernel == "tf32x3":
        assert n_ws == mm.tf32x3_workspace(M, N, K)
    assert n_ws > 0
    a = torch.zeros(M, K, device=cuda, dtype=dtype)
    b = torch.zeros(K, N, device=cuda, dtype=dtype)
    c = torch.full((M, N), 7.0, device=cuda, dtype=dtype)
    ws = torch.empty(n_ws, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for short in (n_ws - 1, 0):
        assert lib.nvdla_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                ws.data_ptr(), short, M, N, K,
                                mm._DTYPES[dtype], code, stream) == 1
    torch.cuda.synchronize()
    assert bool((c == 7).all())   # nothing ran
    assert lib.nvdla_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                            ws.data_ptr(), n_ws, M, N, K, mm._DTYPES[dtype],
                            code, stream) == 0
    torch.cuda.synchronize()
    assert bool((c == 0).all())


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
    (2, 4, 2, 333, 96, 2 * 333 * 96 * 2 * 6 + 2 * 2 * 2 * 96 * 336)])
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
                                       0, 0, code, stream)

    assert call(n_ws - 1) == 1 and call(0) == 1
    torch.cuda.synchronize()
    assert bool((o == 7).all())   # nothing ran
    assert call(n_ws) == 0
    torch.cuda.synchronize()
    assert bool((o == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,dtype,D", [
    ("tf32x3", torch.bfloat16, 64), ("mma_sync", torch.float32, 96),
    ("fma", torch.bfloat16, 16), ("wgmma", torch.float32, 64)])
def test_cuda_flash_refuses_variant_off_its_rule(cuda, kernel, dtype, D):
    q = torch.zeros(1, 2, 64, D, device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="variant"):
        fa.flash_attention(q, q, q, kernel=kernel)


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
