"""The port's CUDA kernels on the card, held against their plain versions.

Every test here is marked ``gpu`` and skips where ``torch.cuda.is_available()``
is False.  The file imports no JAX, so that it runs on a machine with a card
and no JAX:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.convert import to_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa
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
