"""The port's matrix product held against the JAX package's.

On the CPU the port's ``ops.matmul`` runs its plain PyTorch version; it is
compared with the JAX Pallas kernel in interpret mode at every
``tests/test_kernels.py`` matmul parametrization and at the tiling
chooser's default blocks, at that file's tolerances (fp32 2e-4, bf16 2e-2,
atol ``tol * sqrt(K)``; 1e-4 / 1e-3 for the default blocks), and with the
JAX oracle on a shape no Pallas block divides.  ``tests/test_torch_gpu.py``
holds the CUDA kernel against the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import nvdla_matmul as mm

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _ab(seed, M, N, K):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K), np.float32),
            rng.standard_normal((K, N), np.float32))


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                      np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,n,k,bm,bn,bk", [   # tests/test_kernels.py
    (128, 128, 128, 128, 128, 128),
    (256, 128, 384, 128, 128, 128),
    (512, 256, 256, 256, 128, 256),
    (128, 512, 640, 128, 256, 128),
])
def test_matmul_matches_jax_kernel(m, n, k, bm, bn, bk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    a, b = _ab(0, m, n, k)
    expect = jops.matmul(jnp.asarray(a).astype(jdt),
                         jnp.asarray(b).astype(jdt), bm=bm, bn=bn, bk=bk)
    out = ops.matmul(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    assert out.dtype == tdt and out.shape == (m, n)
    np.testing.assert_allclose(_np(out), _np(expect), rtol=tol,
                               atol=tol * k ** 0.5)


def test_matmul_matches_jax_kernel_default_tiling():
    """Blocks from the reference's tiling chooser (tests/test_kernels.py)."""
    a, b = _ab(1, 256, 256, 256)
    expect = jops.matmul(jnp.asarray(a), jnp.asarray(b))
    out = ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(_np(out), _np(expect), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,N,K", [(100, 72, 200), (4, 1152, 300), (1, 3, 1)])
def test_plain_version_matches_jax_oracle_ragged(M, N, K, dtype):
    """Shapes no Pallas block divides: the plain version against the JAX
    oracle, both float32 products of the same inputs, cast to the dtype."""
    jdt, tdt, tol = DTYPES[dtype]
    a, b = _ab(2, M, N, K)
    expect = jref.matmul_ref(jnp.asarray(a).astype(jdt),
                             jnp.asarray(b).astype(jdt))
    out = ref.matmul_ref(torch.from_numpy(a).to(tdt),
                         torch.from_numpy(b).to(tdt))
    assert out.dtype == tdt
    np.testing.assert_allclose(_np(out), _np(expect), rtol=tol,
                               atol=tol * K ** 0.5)


def test_kernel_wrapper_refuses_cpu_tensors():
    a, b = (torch.from_numpy(x) for x in _ab(3, 8, 8, 8))
    before = mm.matmul.launches
    with pytest.raises(ValueError, match="CUDA"):
        mm.matmul(a, b)
    assert mm.matmul.launches == before


def test_dispatch_refuses_other_devices():
    a = torch.zeros(2, 2, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        ops.matmul(a, a)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["nvdla_matmul"])


MODEL_GRID_LARGE = [(4096, 1024, 1152), (4096, 6912, 1152),
                    (1024, 6912, 1152)]   # calibrate.MODEL_GRIDS, M > 16


@pytest.mark.parametrize("M,N,K", MODEL_GRID_LARGE + [
    (4096, 1152, 1152), (4096, 2304, 6912),    # serving prefill projections
    (200, 6912, 1152), (4100, 1032, 1152), (512, 1024, 4096), (17, 8, 8)])
def test_variant_rule_takes_hopper_kernel_for_large_bf16(M, N, K):
    assert mm.variant(M, N, K, torch.bfloat16) == "wgmma"


@pytest.mark.parametrize("M,N,K,dtype,expect", [
    (4, 1152, 6912, torch.bfloat16, "mma_sync"),     # decoding rows
    (4, 262144, 1152, torch.bfloat16, "mma_sync"),
    (16, 1024, 1152, torch.bfloat16, "mma_sync"),
    (17, 130, 33, torch.bfloat16, "mma_sync"),       # K, N off 8
    (128, 130, 128, torch.bfloat16, "mma_sync"),     # N off 8
    (128, 128, 100, torch.bfloat16, "mma_sync"),     # K off 8
    (4096, 6912, 1152, torch.float32, "fma"),
    (4, 1152, 6912, torch.float32, "fma"),
])
def test_variant_rule_keeps_older_kernels(M, N, K, dtype, expect):
    """float32, M <= 16 (split K) and row strides TMA cannot describe keep
    the mma.sync / FMA kernels."""
    assert mm.variant(M, N, K, dtype) == expect


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8])
def test_variant_rule_raises_on_unknown_type(dtype):
    with pytest.raises(TypeError):
        mm.variant(128, 128, 128, dtype)


def test_every_variant_is_counted():
    assert set(mm.matmul.launches_by_variant) == set(mm.VARIANTS)
    mm.reset_counts()
    assert mm.matmul.launches == 0
    assert set(mm.matmul.launches_by_variant.values()) == {0}
