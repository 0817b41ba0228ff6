"""The port's matrix product held against the JAX package's.

On the CPU the port's ``ops.matmul`` runs its plain PyTorch version; it is
compared with the JAX Pallas kernel in interpret mode at every
``tests/test_kernels.py`` matmul parametrization (the port also at each
tile its kernel instantiates) and at the tiling chooser's default blocks, at that file's tolerances (fp32 2e-4, bf16 2e-2,
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
from repro_torch.kernels import _build, calibrate, ops, ref
from repro_torch.kernels import nvdla_matmul as mm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    at, bt = torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)
    out = ops.matmul(at, bt)
    assert out.dtype == tdt and out.shape == (m, n)
    np.testing.assert_allclose(_np(out), _np(expect), rtol=tol,
                               atol=tol * k ** 0.5)
    # and at each tile the variant instantiates (the JAX side keeps the
    # reference's blocks, which are no tile of the port's)
    for tbm, tbn, tbk in mm.tiles(mm.variant(m, n, k, tdt)):
        out = ops.matmul(at, bt, bm=tbm, bn=tbn, bk=tbk)
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
    (4096, 6912, 1152, torch.float32, "tf32x3"),
    (4, 1152, 6912, torch.float32, "stream"),
    (4, 262144, 1152, torch.float32, "stream"),      # calibration model grid
    (4096, 1024, 1152, torch.float32, "tf32x3"),
    (1024, 6912, 1152, torch.float32, "tf32x3"),
    (16, 1024, 1152, torch.float32, "stream"),       # the edge: M = 16, 17
    (17, 1024, 1152, torch.float32, "tf32x3"),
    (1, 3, 1, torch.float32, "stream"),
    (128, 128, 100, torch.float32, "tf32x3"),        # ragged K, any N
    (17, 130, 33, torch.float32, "tf32x3"),
    (4, 130, 33, torch.float32, "stream"),
    (4100, 1031, 1150, torch.float32, "tf32x3"),
] + [(M, N, K, torch.float32, "tf32x3")             # calibration full grid
     for M, N, K in calibrate.FULL_GRIDS["matmul"]])
def test_variant_rule_keeps_older_kernels(M, N, K, dtype, expect):
    """bf16 with M <= 16 or row strides TMA cannot describe keeps the
    mma.sync kernel; float32 takes the streaming kernel for M <= 16 and three
    TF32 passes on wgmma above, for any K and N.  The FMA kernel runs only
    when named."""
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


@pytest.mark.parametrize("M,N,K,expect", [
    (4096, 6912, 1152, 2 * 1152 * (4096 + 6912)),   # K a multiple of 32
    (17, 130, 33, 2 * 64 * (17 + 130)),            # K padded to 64
    (100, 72, 200, 2 * 224 * (100 + 72)),
    (1, 1, 1, 2 * 32 * 2),
    (4100, 1032, 1150, 2 * 1152 * (4100 + 1032)),
])
def test_tf32x3_workspace_holds_padded_split_operands(M, N, K, expect):
    """a_hi, a_lo (M, Kp) and bT_hi, bT_lo (N, Kp), Kp = K rounded up to 32:
    each part's rows are whole 128-byte TMA rows, so every part starts
    16-byte aligned."""
    n = mm.tf32x3_workspace(M, N, K)
    assert n == expect
    kp = n // (2 * (M + N))
    assert kp % 32 == 0 and K <= kp < K + 32
    assert (M * kp * 4) % 16 == 0 and (2 * M * kp * 4) % 16 == 0


def _tf32(x):
    """x (float32) rounded to TF32 as cvt.rna.tf32.f32 does: to nearest on
    the int32 view (ties away from zero), the low 13 mantissa bits
    cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


@pytest.mark.parametrize("M,N,K", [(128, 256, 6912), (64, 1152, 6912)])
def test_three_tf32_passes_meet_the_fp32_tolerance(M, N, K):
    """The tf32x3 design emulated in plain PyTorch: hi·hi + hi·lo + lo·hi in
    float64 holds the float64 product at rtol 2e-4, atol 2e-4 sqrt(K)
    (tests/test_kernels.py) at long K; one TF32 pass (hi·hi) does not, which
    is why the kernel takes three."""
    a, b = (torch.from_numpy(x) for x in _ab(4, M, N, K))
    expect = (a.double() @ b.double()).numpy()
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    assert (a_hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (a_lo.view(torch.int32) & 0x1FFF).eq(0).all()

    def dot(x, y):
        return x.double() @ y.double()

    three = (dot(a_lo, b_hi) + dot(a_hi, b_lo) + dot(a_hi, b_hi)).numpy()
    np.testing.assert_allclose(three, expect, rtol=2e-4, atol=2e-4 * K ** 0.5)
    one = dot(a_hi, b_hi).numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(one, expect, rtol=2e-4,
                                   atol=2e-4 * K ** 0.5)


@pytest.mark.parametrize("name", list(mm.VARIANTS))
def test_every_tile_is_taken_on_the_cpu(name):
    """Each instantiated tile of each variant passes the block check on the
    CPU and leaves the plain version's result as it is."""
    dtype = mm.VARIANTS[name][1]
    M = 4 if name == "stream" else 100
    a, b = (torch.from_numpy(x).to(dtype) for x in _ab(5, M, 72, 200))
    expect = ref.matmul_ref(a, b)
    for bm, bn, bk in mm.tiles(name):
        out = ops.matmul(a, b, bm=bm, bn=bn, bk=bk, kernel=name)
        assert torch.equal(out, expect)
        t = mm.tiling_of(M, 72, 200, dtype, bm=bm, bn=bn, bk=bk, kernel=name)
        assert (t.bm, t.bn, t.bk, t.variant) == (bm, bn, bk, name)


@pytest.mark.parametrize("block", [(128, 128, 128), (256, 128, 256),
                                   (128, 128, 64), (64, 64, 16)])
def test_uninstantiated_block_raises_on_the_cpu(block):
    """A block the kernel does not instantiate raises on the CPU as on the
    card, naming the tiles it has."""
    a, b = (torch.from_numpy(x) for x in _ab(6, 128, 128, 128))
    bm, bn, bk = block
    with pytest.raises(ValueError, match="instantiates") as e:
        ops.matmul(a, b, bm=bm, bn=bn, bk=bk)
    assert str(mm.tiles("tf32x3")) in str(e.value)


def test_any_zero_block_takes_the_chooser():
    """As the reference's ``matmul``: the blocks count only when all three
    are given."""
    t = mm.tiling_of(64, 128, 6272, torch.float32)
    for kw in ({}, {"bm": 128}, {"bm": 999, "bn": 0, "bk": 3}):
        assert mm.tiling_of(64, 128, 6272, torch.float32, **kw) == t


def test_split_counts_the_kernel_cannot_take_raise():
    with pytest.raises(ValueError, match="split"):
        mm.tiling_of(4096, 1024, 1152, torch.bfloat16, splits=2)
    # 1000 over 9 splits: ranges of 128 leave 8 non-empty
    with pytest.raises(ValueError, match="split"):
        mm.tiling_of(64, 128, 1000, torch.float32, splits=9)
    t = mm.tiling_of(64, 128, 1000, torch.float32, splits=8)
    assert t.splits == 8
    assert mm.tiling_of(64, 128, 6272, torch.float32, splits=1).splits == 1


class _OnCard:
    """Stands for a CUDA tensor where only its device is read."""
    device = torch.device("cuda")


def test_ops_forwards_blocks_to_the_kernel(monkeypatch):
    seen = []
    monkeypatch.setattr(mm, "matmul", lambda a, b, **kw: seen.append(kw))
    ops.matmul(_OnCard(), _OnCard(), bm=64, bn=128, bk=32)
    ops.matmul(_OnCard(), _OnCard())
    assert seen == [{"bm": 64, "bn": 128, "bk": 32}, {}]
    checked = []
    real = mm.tiling_of
    monkeypatch.setattr(mm, "tiling_of",
                        lambda *a, **kw: checked.append(kw) or real(*a, **kw))
    a, b = (torch.from_numpy(x) for x in _ab(7, 64, 128, 96))
    ops.matmul(a, b, bm=64, bn=128, bk=32, splits=1)
    assert checked == [{"bm": 64, "bn": 128, "bk": 32, "splits": 1}]


def test_tf32x3_workspace_holds_the_split_partials():
    M, N, K = 64, 128, 6272
    t = mm.tiling_of(M, N, K, torch.float32)
    assert t.splits > 1
    assert mm.tf32x3_workspace(M, N, K, t.splits) == \
        mm.tf32x3_workspace(M, N, K) + t.splits * M * N
