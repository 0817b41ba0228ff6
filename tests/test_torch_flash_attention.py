"""The port's flash attention held against the JAX package's.

On the CPU the port's ``ops.flash_attention`` runs its plain PyTorch version;
it is compared with the JAX Pallas kernel in interpret mode at every
``tests/test_kernels.py`` flash parametrization, each package given that
case's tile (bq, bk), at that file's tolerances (fp32 1e-4, bf16 3e-2), and
with the JAX package's chunked attention on a ragged length.  Every tile
the kernel instantiates is taken on the CPU, any other raises as on the
card, and ``ops`` forwards the tile through its autograd function.
``tests/test_torch_gpu.py`` holds the CUDA kernel against the plain version
on the card.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import chunked_attention
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KERNEL_CASES = [  # B, H, Hkv, S, D, bq, bk, causal, window (test_kernels.py)
    (1, 2, 2, 128, 32, 64, 64, True, 0),
    (2, 4, 2, 128, 64, 64, 32, True, 0),      # GQA
    (1, 2, 1, 256, 32, 128, 64, True, 48),    # MQA + sliding window
    (1, 2, 2, 128, 32, 64, 64, False, 0),     # non-causal (encoder)
    (2, 4, 2, 128, 16, 64, 64, True, 0),      # head dims in padded boxes:
    (1, 2, 1, 256, 96, 128, 64, True, 48),    # 16 (GQA), 96 (MQA, window)
    (2, 4, 4, 128, 192, 64, 64, True, 0),     # MLA's q/k width, MHA
    (1, 4, 4, 128, 80, 64, 64, True, 0),      # zamba2's shared attention,
    (2, 4, 2, 256, 80, 128, 64, True, 48),    # GQA and a window,
    (1, 2, 2, 128, 80, 64, 64, False, 0),     # no causal mask
]
ROOT = Path(__file__).resolve().parents[1]
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
                              causal=causal, window=window, bq=bq, bk=bk)
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
    (16, torch.bfloat16, "wgmma"), (32, torch.bfloat16, "wgmma"),
    (96, torch.bfloat16, "wgmma"), (192, torch.bfloat16, "wgmma"),
    (256, torch.float32, "tf32x3"), (64, torch.float32, "tf32x3"),
    (16, torch.float32, "tf32x3"), (128, torch.float32, "tf32x3"),
    (32, torch.float32, "tf32x3"), (96, torch.float32, "tf32x3"),
    (192, torch.float32, "tf32x3"),
    (80, torch.bfloat16, "wgmma"), (80, torch.float32, "tf32x3"),
])
def test_variant_rule_by_head_dim_and_type(D, dtype, expect):
    """The Hopper variants (bf16 wgmma, float32 three TF32 passes on wgmma)
    take every head dim, those off whole TMA boxes (16, 32, 80, 96) in padded
    boxes: the card's times put them ahead of mma.sync and the FMA kernel
    at each (PERF.md), which run only when named."""
    assert fa.variant(D, dtype) == expect


@pytest.mark.parametrize("D,dtype,exc", [
    (48, torch.bfloat16, ValueError), (512, torch.float32, ValueError),
    (64, torch.float16, TypeError), (256, torch.int32, TypeError)])
def test_variant_rule_raises_on_unknown_head_dim_or_type(D, dtype, exc):
    with pytest.raises(exc):
        fa.variant(D, dtype)


def test_older_variants_are_not_built_at_mla_head_dim():
    """The Hopper variants take every head dim; mma.sync and the FMA
    kernel, which they replaced, are not built at 192 (MLA's q/k width)
    nor at 80 (zamba2's head dim): the wrapper raises before a launch
    there, ``tests/test_torch_gpu.py``."""
    for name in ("wgmma", "tf32x3"):
        assert fa.VARIANT_HEAD_DIMS[name] == fa.HEAD_DIMS
    for name in ("mma_sync", "fma"):
        assert set(fa.HEAD_DIMS) - set(fa.VARIANT_HEAD_DIMS[name]) \
            == {80, 192}
    assert set(fa.VARIANT_HEAD_DIMS) == set(fa.VARIANTS)


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


def _tf32x3_workspace(B, H, Hkv, S, D):
    """float32 elements of flash tf32x3's workspace, as the library's
    ``flash_attention_workspace`` computes them: q and k split in place,
    v transposed with rows padded to Sp = S rounded up to 4."""
    sp = -(-S // 4) * 4
    return 2 * S * D * B * (H + Hkv) + 2 * B * Hkv * D * sp


@pytest.mark.parametrize("B,H,Hkv,S,D,expect", [
    (1, 4, 1, 1024, 256, 2 * 1024 * 256 * 5 + 2 * 256 * 1024),
    (2, 4, 2, 128, 64, 2 * 128 * 64 * 2 * 6 + 2 * 2 * 2 * 64 * 128),
    (1, 4, 1, 1000, 128, 2 * 1000 * 128 * 5 + 2 * 128 * 1000),
    (2, 4, 2, 333, 128, 2 * 333 * 128 * 2 * 6 + 2 * 2 * 2 * 128 * 336),
    (1, 2, 1, 77, 64, 2 * 77 * 64 * 3 + 2 * 64 * 80),
    (1, 4, 1, 1000, 16, 2 * 1000 * 16 * 5 + 2 * 16 * 1000),   # the padded
    (2, 4, 2, 333, 32, 2 * 333 * 32 * 2 * 6 + 2 * 2 * 2 * 32 * 336),  # box
    (4, 32, 32, 1024, 96, 2 * 1024 * 96 * 4 * 64 + 2 * 4 * 32 * 96 * 1024),
    (4, 16, 16, 1024, 192,   # deepseek_v2_lite_16b's MLA prefill
     2 * 1024 * 192 * 4 * 32 + 2 * 4 * 16 * 192 * 1024),
    (4, 32, 32, 1024, 80,    # zamba2_2_7b's shared attention: rows of D,
     2 * 1024 * 80 * 4 * 64 + 2 * 4 * 32 * 80 * 1024),   # not DP = 96
    (2, 4, 2, 333, 80, 2 * 333 * 80 * 2 * 6 + 2 * 2 * 2 * 80 * 336),
])
def test_tf32x3_workspace_holds_split_operands(B, H, Hkv, S, D, expect):
    """q hi/lo (B*H, S, D), k hi/lo (B*Hkv, S, D) and v transposed, hi/lo
    (B*Hkv, D, Sp) with Sp = S rounded up to 4: every part starts 16-byte
    aligned and every row of V^T is whole 16-byte pieces, as TMA needs.
    ``tests/test_torch_gpu.py`` holds the library's
    ``flash_attention_workspace`` to the same counts on the card."""
    n = _tf32x3_workspace(B, H, Hkv, S, D)
    assert n == expect
    nq, nk = B * H * S * D, B * Hkv * S * D
    sp = (n - 2 * (nq + nk)) // (2 * B * Hkv * D)
    assert sp % 4 == 0 and S <= sp < S + 4
    assert all(4 * off % 16 == 0 for off in (nq, 2 * nq, 2 * nq + nk,
                                             2 * (nq + nk)))


def _tf32(x):
    """x (float32) rounded to TF32 as cvt.rna.tf32.f32 does: to nearest on
    the int32 view (ties away from zero), the low 13 mantissa bits
    cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _online_softmax(q, k, v, causal, window, bk, prod, scale_dim=None,
                    p_round=None):
    """The Hopper kernels' attention: an online softmax over tiles of
    ``bk`` keys in exp2 with scale * log2(e) folded in, the scale that of
    head dim ``scale_dim`` (q's by default); ``prod(x, y)`` takes the
    place of x @ y^T for both products, P rounded by ``p_round`` before P
    V; the output acc / max(l, 1e-30).  GQA: query head h reads KV head
    h // (H / Hkv)."""
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    k, v = (t.repeat_interleave(rep, dim=1) for t in (k, v))
    scale_log2 = np.float32(1.4426950408889634 / (scale_dim or D) ** 0.5)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, D)
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        kpos = torch.arange(k0, min(k0 + bk, S))[None, :]
        live = torch.ones(S, kpos.shape[1], dtype=torch.bool)
        if causal:
            live &= qpos >= kpos
        if window:
            live &= qpos - kpos < window
        s = prod(q, k[:, :, k0:k0 + bk]) * scale_log2
        s = torch.where(live, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        if p_round is not None:
            p = p_round(p)
        acc = acc * corr + prod(p, v[:, :, k0:k0 + bk].transpose(-1, -2))
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


def _flash_tf32(q, k, v, causal, window, bk, passes, scale_dim=None):
    """The tf32x3 kernel's arithmetic in plain PyTorch: q, k, v^T and P
    split into TF32 hi and lo; each product the float64 sum of ``passes``
    (lo·hi, hi·lo, hi·hi, or hi·hi alone), rounded to float32 as the
    tensor cores' float32 accumulator holds it."""
    def prod(x, y):
        (xh, xl), (yh, yl) = _split(x), _split(y)
        terms = {"lo.hi": (xl, yh), "hi.lo": (xh, yl), "hi.hi": (xh, yh)}
        return sum(a.double() @ b.double().transpose(-1, -2)
                   for a, b in (terms[p] for p in passes)).float()
    return _online_softmax(q, k, v, causal, window, bk, prod, scale_dim)


def _flash_bf16(q, k, v, causal, window, scale_dim=None):
    """The bf16 wgmma kernel's arithmetic in plain PyTorch: q, k, v and P
    in bf16, both products summed in float64 and held in float32 (the
    accumulator's type), tiles of 64 keys."""
    def prod(x, y):
        return (x.bfloat16().double()
                @ y.bfloat16().double().transpose(-1, -2)).float()
    return _online_softmax(q, k, v, causal, window, 64, prod, scale_dim,
                           p_round=lambda p: p.bfloat16().float())


THREE = ("lo.hi", "hi.lo", "hi.hi")


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,bk", [
    (1, 1, 1, 1024, 256, True, 0, 32),       # a calibration head, D = 256
    (1, 4, 2, 300, 128, True, 100, 64),      # windowed GQA, ragged S
    (1, 2, 1, 200, 64, False, 0, 64),        # no causal mask
    (1, 2, 2, 256, 16, True, 0, 64),         # the padded-box head dims
    (1, 4, 2, 200, 32, True, 50, 64),
    (1, 2, 1, 300, 96, False, 0, 64),
    (1, 4, 2, 200, 80, True, 70, 64),
])
def test_three_tf32_passes_meet_the_fp32_tolerance(B, H, Hkv, S, D, causal,
                                                   window, bk):
    """The tf32x3 design emulated: three TF32 passes for both products hold
    the float64 attention at the float32 tolerance, rtol = atol = 1e-4
    (tests/test_kernels.py), and one pass (hi·hi) does not at D = 256,
    which is why the kernel takes three."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, B, H, Hkv, S, D))
    expect = ref.flash_attention_ref(q.double(), k.double(), v.double(),
                                     causal=causal, window=window).numpy()
    out = _flash_tf32(q, k, v, causal, window, bk, THREE)
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-4)
    if D == 256:
        one = _flash_tf32(q, k, v, causal, window, bk, ("hi.hi",))
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(one.numpy(), expect, rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("D", [16, 32, 80, 96])
@pytest.mark.parametrize("design", ["bf16", "tf32x3"])
def test_padded_boxes_leave_the_output_unchanged(design, D):
    """The Hopper kernels' design at head dims off whole 128-byte TMA boxes:
    q, k and v zero-padded from D to DP (D rounded up to 64 bf16 or 32 fp32
    columns, as TMA fills a box past the tensor's edge) give, with the
    softmax scale of the real D, the unpadded output in their first D
    columns and zeros past them; the scale of DP would not."""
    DP = -(-D // 64) * 64 if design == "bf16" else -(-D // 32) * 32
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, 1, 4, 2, 200, D))
    pad = [torch.nn.functional.pad(t, (0, DP - D)) for t in (q, k, v)]

    def run(q, k, v, scale_dim=None):
        if design == "bf16":
            return _flash_bf16(q, k, v, True, 50, scale_dim)
        return _flash_tf32(q, k, v, True, 50, 64, THREE, scale_dim)
    out = run(q, k, v)
    padded = run(*pad, scale_dim=D)
    assert padded.shape[-1] == DP
    np.testing.assert_allclose(padded[..., :D].numpy(), out.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert not padded[..., D:].any()
    if DP != D:
        wrong = run(*pad)   # the scale of DP
        assert (wrong[..., :D] - out).abs().max().item() > 1e-3


def test_flash_bound_counts_the_exponentials(monkeypatch):
    """``chip_smoke.py::bound`` takes the largest of operations, one
    exponential a live pair and bytes: bf16 at head dim 16 (phi3's prefill
    shape) is set by the exponentials, at 256 (gemma3_1b's) by the
    operations."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    ms, by, terms = chip_smoke.bound(4, 32, 32, 1024, 16, 0, torch.bfloat16,
                                     "wgmma")[:3]
    live = 4 * 32 * 1024 * 1025 // 2
    assert by == "exp" and terms["exp"] == live / chip_smoke.hw.EXP_RATE
    assert ms == 1e3 * terms["exp"] > 1e3 * terms["operations"]
    ms, by, terms = chip_smoke.bound(4, 4, 1, 1024, 256, 0, torch.bfloat16,
                                     "wgmma")[:3]
    assert by == "operations" and terms["operations"] > terms["exp"]


# ---------------------------------------------------------------------------
# the block's tile from the caller


HOPPER = ("wgmma", "tf32x3")
VARIANT_DTYPE = {name: dtype for name, (_, dtype) in fa.VARIANTS.items()}
EVERY_TILE = [(name, D, tile) for name in fa.VARIANTS
              for D in fa.VARIANT_HEAD_DIMS[name] for tile in fa.tiles(name, D)]


def test_tile_set_holds_the_reference_sweep_and_fits():
    """Both Hopper variants instantiate, at every head dim, the default
    (64, 64), or 64 x 32 for tf32x3 above D 128, first; at D 32 and 64 every
    tile of ``tests/test_kernels.py``'s flash sweep; at D 256 tf32x3 only
    its default.  Every tile's block fits the card's 232,448 bytes, and
    every other (bq, bk) of the set that is left out does not."""
    for name in HOPPER:
        for D in fa.HEAD_DIMS:
            tiles = fa.tiles(name, D)
            assert tiles[0] == (64, 32 if D > 128 and name == "tf32x3"
                                else 64)
            assert len(set(tiles)) == len(tiles)
            for bq in fa.TILE_BQ:
                for bk in fa.TILE_BK:
                    stages, smem, _ = fa._layout(name, D, bq, bk)
                    fits = smem <= fa.SMEM_MAX and stages >= 1
                    assert ((bq, bk) in tiles) == fits, (name, D, bq, bk)
                    assert fits == fa._fits(name, D, bq, bk)
        for D in (32, 64):
            assert {(64, 64), (64, 32), (128, 64)} <= set(fa.tiles(name, D))
    assert len(fa.tiles("wgmma", 256)) == 6
    assert fa.tiles("tf32x3", 256) == ((64, 32),)
    for name in ("fma", "mma_sync"):
        assert all(fa.tiles(name, D) == (fa.default_tile(name, D),)
                   for D in fa.VARIANT_HEAD_DIMS[name])
        assert fa.tiles(name, 80) == fa.tiles(name, 192) == ()


@pytest.mark.parametrize("name,D,bq,bk,stages,smem", [
    # csrc/flash_attention.cuh's table of the default tiles, bytes exactly
    ("tf32x3", 16, 64, 64, 4, 83000), ("tf32x3", 64, 64, 64, 4, 132152),
    ("tf32x3", 96, 64, 64, 3, 156716), ("tf32x3", 128, 64, 64, 3, 197676),
    ("tf32x3", 192, 64, 32, 2, 164896), ("tf32x3", 256, 64, 32, 2, 214048),
    # other tiles: stages where shared memory ends
    ("tf32x3", 80, 128, 64, 2, 214048), ("tf32x3", 192, 64, 64, 2, 230432),
    ("tf32x3", 64, 64, 128, 4, 230456),
    ("wgmma", 256, 64, 64, 1, 99360), ("wgmma", 256, 128, 128, 1, 197664),
    ("wgmma", 16, 64, 32, 1, 17440)])
def test_tile_layout(name, D, bq, bk, stages, smem):
    t = fa.tile_of(D, VARIANT_DTYPE[name], bq=bq, bk=bk)
    assert (t.variant, t.bq, t.bk, t.stages, t.smem_bytes, t.threads) == \
        (name, bq, bk, stages, smem, 2 * bq)


@pytest.mark.parametrize("name,D,tile", EVERY_TILE)
def test_every_tile_is_taken_on_the_cpu(name, D, tile):
    """Each tile of ``tiles(name, D)`` passes ``ops.flash_attention``'s
    check on the CPU and gives the plain version's output unchanged."""
    dtype = VARIANT_DTYPE[name]
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(7, 1, 2, 1, 40, D))
    expect = ref.flash_attention_ref(q, k, v, causal=True, window=0)
    out = ops.flash_attention(q, k, v, bq=tile[0], bk=tile[1], kernel=name)
    assert torch.equal(out, expect)
    t = fa.tile_of(D, dtype, bq=tile[0], bk=tile[1], kernel=name)
    assert (t.variant, t.bq, t.bk) == (name, *tile)


@pytest.mark.parametrize("D,dtype,kw", [
    (64, torch.bfloat16, dict(bq=256, bk=256)),
    (64, torch.bfloat16, dict(bq=64, bk=48)),
    (64, torch.float32, dict(bq=64)),            # one value without the other
    (64, torch.float32, dict(bk=64)),
    (256, torch.float32, dict(bq=128, bk=64)),   # does not fit at D 256
    (128, torch.float32, dict(bq=128, bk=128)),
    (64, torch.bfloat16, dict(bq=128, bk=64, kernel="mma_sync")),
    (256, torch.float32, dict(bq=64, bk=64, kernel="fma")),
    (80, torch.float32, dict(kernel="fma")),     # not built at 80
    (64, torch.float32, dict(bq=64, bk=64, kernel="wgmma")),   # bf16 only
])
def test_a_tile_not_instantiated_raises_on_the_cpu(D, dtype, kw):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(8, 1, 2, 1, 16, D))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, **kw)
    with pytest.raises(ValueError):
        fa.tile_of(D, dtype, **kw)


def _card_path(monkeypatch, seen):
    """``ops`` sends CPU tensors down the card's path (its autograd
    function) with the kernel replaced by the plain version, recording the
    keywords the kernel gets."""
    def kernel(q, k, v, *, causal, window, **kw):
        assert not torch.is_grad_enabled()
        seen.append(kw)
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(fa, "flash_attention", kernel)
    monkeypatch.setattr(ops, "_dispatch", lambda name, plain, kern, device,
                        *args, **kw: kern(*args, **kw))


def test_ops_forwards_the_tile_to_the_kernel(monkeypatch):
    """``ops.flash_attention`` passes ``bq``, ``bk`` and ``kernel`` through
    ``_FlashAttention`` to the kernel, and nothing where none is given."""
    seen = []
    _card_path(monkeypatch, seen)
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, 1, 2, 1, 40, 64))
    ops.flash_attention(q, k, v, bq=128, bk=64)
    ops.flash_attention(q, k, v, window=8, bq=64, bk=32, kernel="tf32x3")
    ops.flash_attention(q, k, v)
    assert seen == [{"bq": 128, "bk": 64},
                    {"bq": 64, "bk": 32, "kernel": "tf32x3"}, {}]


@pytest.mark.parametrize("tile", [(128, 64), (64, 32), (128, 128)])
def test_gradient_with_a_tile_equals_the_gradient_without(monkeypatch, tile):
    """The backward is the plain version's gradient, which has no tile: on
    the card's path the gradients with a tile given are those without."""
    _card_path(monkeypatch, [])
    arrays = _qkv(10, 1, 4, 2, 70, 32)
    dout = torch.from_numpy(_qkv(11, 1, 4, 4, 70, 32)[0])

    def grads(**kw):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        out = ops.flash_attention(*ts, window=30, **kw)
        return [out.detach(), *torch.autograd.grad(out, ts, dout)]
    for got, expect in zip(grads(bq=tile[0], bk=tile[1]), grads()):
        assert torch.equal(got, expect)

