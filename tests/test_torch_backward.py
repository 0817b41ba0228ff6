"""The backward passes of the port's kernels held against the JAX package's
autodiff, on the CPU.

On the card ``ops.flash_attention`` and ``ops.mamba_scan`` run the kernel
forward and, backward, ``ref.flash_attention_bwd_ref`` /
``ref.mamba_scan_bwd_ref``: the plain version recomputed and
differentiated.  Here those are held against ``jax.vjp`` of the reference's
oracles, ``repro.kernels.ref.flash_attention_ref`` (KV repeated to the
query heads, as ``tests/test_kernels.py`` does; the gradient summed back
over each group) and ``mamba_scan_ref``, on numpy inputs from a seed, at
``tests/test_kernels.py``'s float32 tolerances (flash 1e-4; scan rtol 2e-4,
atol 8e-4).  The scan's starting and final states, which the reference's
oracle lacks, are held against a ``lax.scan`` of the same recurrence.  The
CPU path of ``ops`` (the plain version under torch autograd) is held too,
and the raw wrappers refuse a tensor that requires grad before any launch.
The autograd functions themselves, and a train step through them, are
rehearsed here with the kernels replaced by their plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import configs as tconfigs
from repro_torch.data import synthetic_batch
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import mamba_scan as tscan
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw_init
from repro_torch.train import step as tstep

FLASH_TOL = 1e-4
SCAN_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(out, expect, rtol, atol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(expect, np.float32), rtol=rtol,
                               atol=atol)


# tests/test_kernels.py's flash shapes, then two past ref.BWD_Q_CHUNK rows
# (the backward's chunks; the last one ragged), causal with a window and GQA,
# and non-causal
FLASH_CASES = [
    (1, 2, 2, 128, 32, True, 0),
    (2, 4, 2, 128, 64, True, 0),
    (1, 2, 1, 256, 32, True, 48),
    (1, 2, 2, 128, 32, False, 0),
    (1, 4, 2, 640, 16, True, 100),
    (1, 2, 1, 600, 16, False, 0),
]


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", FLASH_CASES)
def test_flash_attention_bwd_ref_matches_jax_vjp(B, H, Hkv, S, D, causal,
                                                 window):
    q, k, v = (_normal(i, B, h, S, D) for i, h in enumerate((H, Hkv, Hkv)))
    dout = _normal(3, B, H, S, D)
    G = H // Hkv

    def f(q, k, v):
        return jref.flash_attention_ref(q, jnp.repeat(k, G, 1),
                                        jnp.repeat(v, G, 1), causal=causal,
                                        window=window)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    expect = vjp(jnp.asarray(dout))
    got = ref.flash_attention_bwd_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(dout),
        causal=causal, window=window)
    for g, e in zip(got, expect):
        assert g.dtype == torch.float32
        _close(g.numpy(), e, FLASH_TOL, FLASH_TOL)
    # the CPU path of ops: the plain version under autograd
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    for g, e in zip(torch.autograd.grad(out, (tq, tk, tv),
                                        torch.from_numpy(dout)), expect):
        _close(g.numpy(), e, FLASH_TOL, FLASH_TOL)


def test_flash_attention_bwd_ref_keeps_dtypes():
    """bf16 inputs give bf16 gradients: the float32 gradient at the bf16
    inputs, rounded once."""
    t = [torch.from_numpy(_normal(i, 1, 2, 64, 16)).bfloat16()
         for i in range(4)]
    got = ref.flash_attention_bwd_ref(*t, causal=True)
    expect = ref.flash_attention_bwd_ref(*(a.float() for a in t),
                                         causal=True)
    for g, e in zip(got, expect):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, e.bfloat16())


def _scan_inputs(b, S, d, N, seed=5):
    x = _normal(seed, b, S, d)
    dt = np.log1p(np.exp(_normal(seed + 1, b, S, d)))
    Bm, Cm = _normal(seed + 2, b, S, N), _normal(seed + 3, b, S, N)
    A = -np.exp(_normal(seed + 4, d, N) * 0.3)
    D = np.ones(d, np.float32)
    return [a.astype(np.float32) for a in (x, dt, Bm, Cm, A, D)]


@pytest.mark.parametrize("b,S,d,N", [(1, 32, 16, 8), (2, 64, 32, 16),
                                     (1, 128, 64, 8)])
def test_mamba_scan_bwd_ref_matches_jax_vjp(b, S, d, N):
    ins = _scan_inputs(b, S, d, N)
    dy = _normal(9, b, S, d)
    _, vjp = jax.vjp(jref.mamba_scan_ref, *(jnp.asarray(a) for a in ins))
    expect = vjp(jnp.asarray(dy))
    got = ref.mamba_scan_bwd_ref(*(torch.from_numpy(a) for a in ins), None,
                                 torch.from_numpy(dy))
    assert got[6] is None
    for g, e in zip(got[:6], expect):
        _close(g.numpy(), e, SCAN_TOL, 4 * SCAN_TOL)
    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    y = ops.mamba_scan(*ts)
    for g, e in zip(torch.autograd.grad(y, ts, torch.from_numpy(dy)),
                    expect):
        _close(g.numpy(), e, SCAN_TOL, 4 * SCAN_TOL)


def _jax_scan_with_state(x, dt, Bm, Cm, A, D, h0):
    """The reference oracle's recurrence from ``h0``, returning (y, h_S)."""
    def step(h, inp):
        x_t, dt_t, B_t, C_t = inp
        h = jnp.exp(dt_t[..., None] * A[None]) * h \
            + dt_t[..., None] * B_t[:, None, :] * x_t[..., None]
        return h, jnp.einsum("bdn,bn->bd", h, C_t)
    hS, ys = jax.lax.scan(step, h0, tuple(a.transpose(1, 0, 2)
                                          for a in (x, dt, Bm, Cm)))
    return ys.transpose(1, 0, 2) + D * x, hS


def test_mamba_scan_bwd_ref_with_states_matches_jax_vjp():
    """With h0 in and h_S out: the gradients of the six inputs and of h0
    against dy and dh_S."""
    b, S, d, N = 2, 48, 32, 16
    ins = _scan_inputs(b, S, d, N, seed=11)
    h0 = _normal(17, b, d, N)
    dy, dh = _normal(18, b, S, d), _normal(19, b, d, N)
    _, vjp = jax.vjp(_jax_scan_with_state,
                     *(jnp.asarray(a) for a in ins + [h0]))
    expect = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = ref.mamba_scan_bwd_ref(*(torch.from_numpy(a) for a in ins),
                                 torch.from_numpy(h0), torch.from_numpy(dy),
                                 torch.from_numpy(dh))
    for g, e in zip(got, expect):
        _close(g.numpy(), e, SCAN_TOL, 4 * SCAN_TOL)
    ts = [torch.from_numpy(a).requires_grad_() for a in ins + [h0]]
    y, hS = ops.mamba_scan(*ts[:6], h0=ts[6], return_state=True)
    grads = torch.autograd.grad((y, hS), ts, (torch.from_numpy(dy),
                                              torch.from_numpy(dh)))
    for g, e in zip(grads, expect):
        _close(g.numpy(), e, SCAN_TOL, 4 * SCAN_TOL)


def test_raw_wrappers_refuse_grad():
    """The kernel wrappers fill their outputs through raw pointers, which
    autograd cannot see: under grad, an input that requires grad is
    refused before the device check, so this holds on the CPU too; under
    ``torch.no_grad()`` the same call goes on to the device check."""
    q = torch.zeros(1, 2, 16, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        tflash.flash_attention(q, q.detach(), q.detach())
    x = torch.zeros(1, 8, 4, requires_grad=True)
    B = torch.zeros(1, 8, 8)
    args = (x, x.detach(), B, B, torch.zeros(4, 8), torch.zeros(4))
    with pytest.raises(RuntimeError, match="requires grad"):
        tscan.mamba_scan(*args)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            tflash.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="CUDA"):
            tscan.mamba_scan(*args)


def test_autograd_functions_wire_the_plain_gradients(monkeypatch):
    """``ops``' autograd functions, with the kernels replaced by their plain
    versions (run under no grad, as a kernel's output carries none): each
    gradient, of every input and of the final state, equals autograd's
    through the plain version, with and without h0 and h_S."""
    def kernel(plain):
        def run(*args, **kw):
            assert not torch.is_grad_enabled()
            return plain(*args, **kw)
        return run
    monkeypatch.setattr(ops._flash, "flash_attention",
                        kernel(ref.flash_attention_ref))
    monkeypatch.setattr(ops._mamba, "mamba_scan", kernel(ref.mamba_scan_ref))

    q, k, v, dout = (_normal(i, 1, 4, 96, 16) for i in range(4))
    k, v = k[:, :2], v[:, :2]

    def flash_grads(fn):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fn(*ts)
        return [out.detach()] + list(torch.autograd.grad(
            out, ts, torch.from_numpy(dout)))
    got = flash_grads(lambda *t: ops._FlashAttention.apply(*t, True, 40))
    expect = flash_grads(lambda *t: ref.flash_attention_ref(
        *t, causal=True, window=40))
    for g, e in zip(got, expect):
        _close(g.numpy(), e.numpy(), FLASH_TOL, FLASH_TOL)

    ins = _scan_inputs(2, 24, 16, 8, seed=21)
    h0 = _normal(27, 2, 16, 8)
    dy, dh = _normal(28, 2, 24, 16), _normal(29, 2, 16, 8)
    for with_h0 in (False, True):
        for return_state in (False, True):
            def scan_grads(fn):
                ts = [torch.from_numpy(a).requires_grad_()
                      for a in ins + ([h0] if with_h0 else [])]
                out = fn(*ts[:6], ts[6] if with_h0 else None)
                outs = out if return_state else (out,)
                grads = (torch.from_numpy(dy), torch.from_numpy(dh))
                return list(torch.autograd.grad(outs, ts,
                                                grads[:len(outs)]))
            got = scan_grads(lambda *t: ops._MambaScan.apply(*t,
                                                             return_state))
            expect = scan_grads(lambda *t: ref.mamba_scan_ref(
                *t[:6], h0=t[6], return_state=return_state))
            assert len(got) == 6 + with_h0
            for g, e in zip(got, expect):
                _close(g.numpy(), e.numpy(), SCAN_TOL, 4 * SCAN_TOL)


def _attention_layers(cfg):
    """The layers whose forward calls the flash kernel once (the ssm
    family's, the scan)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers + (cfg.encoder.n_layers if cfg.encoder else 0)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_card_path_train_step_matches_plain(arch, monkeypatch):
    """The card's training path rehearsed on the CPU: ``ops`` sends CPU
    tensors through its autograd functions, the kernels replaced by their
    plain versions under no grad, so that every block's forward and its
    checkpointed recompute call the "kernel".  One train step in 2
    microbatches: each attention (or scan) layer's kernel, and a Mamba1
    layer's two coefficient kernels, run twice a microbatch, and the loss, the grad norm (2e-2) and every gradient leaf
    (relative L2 3e-2, the bf16 bound of ``_torch_grads.py``) match the
    plain path's."""
    calls = {"flash": 0, "scan": 0, "conv1d_silu": 0, "dt_softplus": 0}

    def kernel(plain, key):
        def run(*args, **kw):
            assert not torch.is_grad_enabled()
            calls[key] += 1
            return plain(*args, **kw)
        return run
    monkeypatch.setattr(ops._flash, "flash_attention",
                        kernel(ref.flash_attention_ref, "flash"))
    monkeypatch.setattr(ops._mamba, "mamba_scan",
                        kernel(ref.mamba_scan_ref, "scan"))
    for name in ("conv1d_silu", "dt_softplus"):
        monkeypatch.setattr(ops._coeffs, name,
                            kernel(getattr(ref, f"{name}_ref"), name))
    card_path = {"on": False}
    dispatch = ops._dispatch

    def route(name, plain, kern, device, *args, **kw):
        if card_path["on"]:
            return kern(*args, **kw)
        return dispatch(name, plain, kern, device, *args, **kw)
    monkeypatch.setattr(ops, "_dispatch", route)
    captured = []
    clip = tstep.clip_by_global_norm

    def capture(grads, max_norm):
        captured.append([g.detach().float().clone() for g in grads])
        return clip(grads, max_norm)
    monkeypatch.setattr(tstep, "clip_by_global_norm", capture)

    cfg = tconfigs.get_smoke_config(arch)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        cfg, 2, 32, np.random.default_rng(3)).items()}
    metrics = []
    for on in (True, False):
        card_path["on"] = on
        params = TT.init_params(cfg, seed=1, device="cpu")
        step = tstep.make_train_step(cfg, tstep.TrainConfig(
            lr=1e-3, warmup=1, n_microbatches=2))
        metrics.append(step(params, adamw_init(params), batch, 1)[2])
        if on:
            key = "scan" if cfg.family == "ssm" else "flash"
            n = cfg.n_layers if key == "scan" else _attention_layers(cfg)
            ran = (key, "conv1d_silu", "dt_softplus") if key == "scan" \
                else (key,)
            assert all(calls[k] == 2 * 2 * n for k in ran)
            assert sum(calls.values()) == len(ran) * calls[key]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[0][key]),
                                   float(metrics[1][key]), rtol=2e-2)
    for g, e in zip(*captured):
        assert float((g - e).norm() / e.norm().clamp(min=1e-30)) <= 3e-2
