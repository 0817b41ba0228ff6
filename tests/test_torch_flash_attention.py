"""The port's flash attention held against the JAX package's.

On the CPU the port's ``ops.flash_attention`` runs its plain PyTorch version;
it is compared with the JAX Pallas kernel in interpret mode at every
``tests/test_kernels.py`` flash parametrization, at that file's tolerances
(fp32 1e-4, bf16 3e-2), and with the JAX package's chunked attention on a
ragged length.  ``tests/test_torch_gpu.py`` holds the CUDA kernel against
the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import chunked_attention
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa

KERNEL_CASES = [  # B, H, Hkv, S, D, bq, bk, causal, window (test_kernels.py)
    (1, 2, 2, 128, 32, 64, 64, True, 0),
    (2, 4, 2, 128, 64, 64, 32, True, 0),      # GQA
    (1, 2, 1, 256, 32, 128, 64, True, 48),    # MQA + sliding window
    (1, 2, 2, 128, 32, 64, 64, False, 0),     # non-causal (encoder)
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(seed, B, H, Hkv, S, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D), np.float32),
            rng.standard_normal((B, Hkv, S, D), np.float32),
            rng.standard_normal((B, Hkv, S, D), np.float32))


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                      np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,Hkv,S,D,bq,bk,causal,window", KERNEL_CASES)
def test_flash_attention_matches_jax_kernel(B, H, Hkv, S, D, bq, bk, causal,
                                            window, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _qkv(0, B, H, Hkv, S, D)
    expect = jops.flash_attention(*(jnp.asarray(a).astype(jdt) for a in arrays),
                                  causal=causal, window=window, bq=bq, bk=bk)
    out = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrays),
                              causal=causal, window=window)
    assert out.dtype == tdt and out.shape == (B, H, S, D)
    np.testing.assert_allclose(_np(out), _np(expect), rtol=tol, atol=tol)


def test_flash_attention_matches_chunked_attention_ragged():
    """GQA, a sliding window and S = 100, which no kernel tile divides.
    fp32 on both sides; 1e-4 covers the different summation orders."""
    arrays = _qkv(1, 2, 4, 2, 100, 32)
    expect = chunked_attention(*(jnp.asarray(a) for a in arrays), causal=True,
                               window=24, chunk=32)
    out = ops.flash_attention(*(torch.from_numpy(a) for a in arrays),
                              causal=True, window=24)
    np.testing.assert_allclose(_np(out), _np(expect), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40), (False, 0)])
def test_plain_version_matches_jax_oracle(causal, window):
    """The plain version takes KV at its native Hkv heads; the JAX oracle
    takes it repeated to H heads."""
    q, k, v = _qkv(2, 2, 6, 2, 96, 16)
    kf, vf = (np.repeat(a, 3, axis=1) for a in (k, v))
    expect = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(kf),
                                      jnp.asarray(vf), causal=causal,
                                      window=window)
    out = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window)
    np.testing.assert_allclose(_np(out), _np(expect), rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 2, 1, 16, 16))
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_attention"])


SERVING_SHAPES = [  # B, H, Hkv, S, D of the gemma3_1b serving path
    (4, 4, 1, 1024, 256), (2, 4, 1, 600, 256), (1, 4, 1, 77, 256)]


@pytest.mark.parametrize("B,H,Hkv,S,D", SERVING_SHAPES)
def test_variant_rule_takes_hopper_kernel_at_serving_shapes(B, H, Hkv, S, D):
    assert fa.variant(D, torch.bfloat16) == "wgmma"


@pytest.mark.parametrize("D,dtype,expect", [
    (64, torch.bfloat16, "wgmma"), (128, torch.bfloat16, "wgmma"),
    (16, torch.bfloat16, "mma_sync"), (32, torch.bfloat16, "mma_sync"),
    (96, torch.bfloat16, "mma_sync"),
    (256, torch.float32, "fma"), (64, torch.float32, "fma"),
    (16, torch.float32, "fma"),
])
def test_variant_rule_by_head_dim_and_type(D, dtype, expect):
    """bf16 takes wgmma only where its 64-element TMA boxes tile D; float32
    always takes the FMA kernel (no tensor-core type meets 1e-4)."""
    assert fa.variant(D, dtype) == expect


@pytest.mark.parametrize("D,dtype,exc", [
    (48, torch.bfloat16, ValueError), (512, torch.float32, ValueError),
    (64, torch.float16, TypeError), (256, torch.int32, TypeError)])
def test_variant_rule_raises_on_unknown_head_dim_or_type(D, dtype, exc):
    with pytest.raises(exc):
        fa.variant(D, dtype)


def test_every_variant_is_counted():
    assert set(fa.flash_attention.launches_by_variant) == set(fa.VARIANTS)
    assert {fa.variant(D, dt) for D in fa.HEAD_DIMS
            for dt in (torch.float32, torch.bfloat16)} <= set(fa.VARIANTS)


def test_library_path_covers_shared_headers(monkeypatch, tmp_path):
    """Editing a header that the sources include rebuilds them: the library
    path of every source changes with it."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n)
              for n in ("flash_attention", "nvdla_matmul")}
    assert before == {n: _build.library_path(n) for n in before}
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)
