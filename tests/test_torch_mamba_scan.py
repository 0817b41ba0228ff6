"""The port's selective scan held against the JAX package's.

On the CPU the port's ``ops.mamba_scan`` runs its plain PyTorch version; it
is compared with the JAX Pallas kernel in interpret mode at every
``tests/test_kernels.py`` scan parametrization, each package given that
case's tile (bd, chunk), at that file's tolerances (fp32 2e-4, bf16 8e-2,
atol ``4 * tol``), and with the JAX oracle on a shape no Pallas block
divides.  Every tile the kernel instantiates is taken on the CPU, any other
raises as on the card, and ``ops`` forwards the tile through its autograd
function.  Inputs are made as that file makes them:
dt = softplus(z), A = -exp(0.3 z), D = 1.  ``tests/test_torch_gpu.py``
holds the CUDA kernel against the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import mamba_scan as ms


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 8e-2)}


def _inputs(seed, b, S, d, N):
    """x, dt, B, C (cast to the working type by the caller), A, D float32."""
    rng = np.random.default_rng(seed)
    z = lambda *s: rng.standard_normal(s, np.float32)  # noqa: E731
    x, dt = z(b, S, d), np.logaddexp(0, z(b, S, d)).astype(np.float32)
    return (x, dt, z(b, S, N), z(b, S, N),
            -np.exp(0.3 * z(d, N)).astype(np.float32),
            np.ones(d, np.float32))


def _jax(arrays, jdt):
    return [jnp.asarray(a).astype(jdt) for a in arrays[:4]] \
        + [jnp.asarray(a) for a in arrays[4:]]


def _torch(arrays, tdt):
    return [torch.from_numpy(a).to(tdt) for a in arrays[:4]] \
        + [torch.from_numpy(a) for a in arrays[4:]]


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                      np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,S,d,N,bd,chunk", [   # tests/test_kernels.py
    (1, 32, 16, 8, 16, 16),
    (2, 64, 32, 16, 16, 32),
    (1, 128, 64, 8, 32, 64),
])
def test_mamba_scan_matches_jax_kernel(b, S, d, N, bd, chunk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(0, b, S, d, N)
    expect = jops.mamba_scan(*_jax(arrays, jdt), bd=bd, chunk=chunk)
    out = ops.mamba_scan(*_torch(arrays, tdt), bd=bd, chunk=chunk)
    assert out.dtype == tdt and out.shape == (b, S, d)
    np.testing.assert_allclose(_np(out), _np(expect), rtol=tol, atol=tol * 4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_version_matches_jax_oracle_ragged(dtype):
    """S = 77 and d = 40, which no Pallas block divides."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(1, 2, 77, 40, 16)
    expect = jref.mamba_scan_ref(*_jax(arrays, jdt))
    out = ref.mamba_scan_ref(*_torch(arrays, tdt))
    assert out.dtype == tdt
    np.testing.assert_allclose(_np(out), _np(expect), rtol=tol, atol=tol * 4)


def test_kernel_wrapper_refuses_cpu_tensors():
    args = _torch(_inputs(2, 1, 8, 4, 8), torch.float32)
    before = ms.mamba_scan.launches
    with pytest.raises(ValueError, match="CUDA"):
        ms.mamba_scan(*args)
    assert ms.mamba_scan.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["mamba_scan"])


def _scan(x, dt, B, C, A, D, decay):
    """The selective scan with the state decay ``decay(dt_t, A)``, in the
    inputs' type: h = decay h + (dt_t x_t) B_t, y_t = sum_n h C_t + D x_t."""
    b, S, d = x.shape
    h = torch.zeros(b, d, A.shape[1], dtype=x.dtype)
    ys = []
    for t in range(S):
        dt_t = dt[:, t, :, None]
        h = decay(dt_t, A) * h + (dt_t * x[:, t, :, None]) * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(-1) + D * x[:, t])
    return torch.stack(ys, 1)


def test_exp2_with_prescaled_a_meets_the_fp32_tolerance():
    """The kernel's state step emulated in float32: the decay as
    exp2(dt * (A log2 e)), with A scaled by log2 e once and rounded to
    float32, holds the float64 scan with exp(dt A) at the reference's
    float32 tolerance (rtol 2e-4, atol 4 x 2e-4) over 2048 steps, on inputs
    made as the calibration makes them (dt = softplus(z), A = -exp(0.3 z))."""
    x, dt, B, C, A, D = (torch.from_numpy(a)
                         for a in _inputs(3, 1, 2048, 64, 16))
    a2 = A * np.float32(np.log2(np.e))
    assert a2.dtype == torch.float32
    out = _scan(x, dt, B, C, a2, D, lambda dt_t, a: torch.exp2(dt_t * a))
    expect = _scan(*(t.double() for t in (x, dt, B, C, A, D)),
                   lambda dt_t, a: torch.exp(dt_t * a))
    np.testing.assert_allclose(out.numpy(), expect.numpy(), rtol=2e-4,
                               atol=8e-4)
    plain = ref.mamba_scan_ref(x, dt, B, C, A, D)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=2e-4,
                               atol=8e-4)


# ---------------------------------------------------------------------------
# the block's tile from the caller


def test_tile_set_holds_the_reference_sweep():
    """bd and chunk each 16, 32 or 64, the default (32, 32) first; the
    set holds ``tests/test_kernels.py``'s (16, 16), (16, 32), (32, 64)."""
    tiles = ms.tiles()
    assert tiles[0] == (32, 32) == ms.tile_of()
    assert sorted(tiles) == [(bd, c) for bd in (16, 32, 64)
                             for c in (16, 32, 64)]
    assert {(16, 16), (16, 32), (32, 64)} <= set(tiles)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tile", ms.tiles())
def test_every_tile_is_taken_on_the_cpu(tile, dtype):
    """Each tile passes ``ops.mamba_scan``'s check on the CPU and gives
    the plain version's output and final state unchanged (S 77, d 40)."""
    tdt = DTYPES[dtype][1]
    args = _torch(_inputs(4, 2, 77, 40, 16), tdt)
    h0 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 40, 16), np.float32))
    y, h = ops.mamba_scan(*args, h0=h0, return_state=True, bd=tile[0],
                          chunk=tile[1])
    y_ref, h_ref = ref.mamba_scan_ref(*args, h0=h0, return_state=True)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)


@pytest.mark.parametrize("kw", [dict(bd=48, chunk=16), dict(bd=16),
                                dict(chunk=32), dict(bd=128, chunk=128),
                                dict(bd=32, chunk=8)])
def test_a_tile_not_instantiated_raises_on_the_cpu(kw):
    args = _torch(_inputs(6, 1, 8, 4, 8), torch.float32)
    with pytest.raises(ValueError):
        ops.mamba_scan(*args, **kw)
    with pytest.raises(ValueError):
        ms.tile_of(**kw)


def _card_path(monkeypatch, seen):
    """``ops`` sends CPU tensors down the card's path (its autograd
    function) with the kernel replaced by the plain version, recording the
    keywords the kernel gets."""
    def kernel(*args, h0=None, return_state=False, **kw):
        assert not torch.is_grad_enabled()
        seen.append(kw)
        return ref.mamba_scan_ref(*args, h0=h0, return_state=return_state)
    monkeypatch.setattr(ms, "mamba_scan", kernel)
    monkeypatch.setattr(ops, "_dispatch", lambda name, plain, kern, device,
                        *args, **kw: kern(*args, **kw))


def test_ops_forwards_the_tile_to_the_kernel(monkeypatch):
    """``ops.mamba_scan`` passes ``bd`` and ``chunk`` through
    ``_MambaScan`` to the kernel, and nothing where none is given."""
    seen = []
    _card_path(monkeypatch, seen)
    args = _torch(_inputs(7, 1, 16, 8, 8), torch.float32)
    ops.mamba_scan(*args, bd=16, chunk=64)
    ops.mamba_scan(*args, return_state=True, bd=64, chunk=16)
    ops.mamba_scan(*args)
    assert seen == [{"bd": 16, "chunk": 64}, {"bd": 64, "chunk": 16}, {}]


@pytest.mark.parametrize("tile", [(16, 16), (64, 32), (32, 64)])
def test_gradient_with_a_tile_equals_the_gradient_without(monkeypatch, tile):
    """The backward is the plain version's gradient, which has no tile: on
    the card's path the gradients of y and h_S with a tile given are those
    without."""
    _card_path(monkeypatch, [])
    arrays = _inputs(8, 2, 24, 16, 8)
    rng = np.random.default_rng(9)
    h0 = rng.standard_normal((2, 16, 8), np.float32)
    dy = torch.from_numpy(rng.standard_normal((2, 24, 16), np.float32))
    dh = torch.from_numpy(rng.standard_normal((2, 16, 8), np.float32))

    def grads(**kw):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays + (h0,)]
        y, h = ops.mamba_scan(*ts[:6], h0=ts[6], return_state=True, **kw)
        return [y.detach(), h.detach(),
                *torch.autograd.grad((y, h), ts, (dy, dh))]
    for got, expect in zip(grads(bd=tile[0], chunk=tile[1]), grads()):
        assert torch.equal(got, expect)

