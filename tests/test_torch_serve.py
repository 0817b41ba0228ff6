"""The port's serving slice held against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX
params are carried across with ``repro_torch.convert``.  The working type is
bf16, which keeps 8 significant bits (a step of 2**-8 relative).  Embedding,
norms and projections round identically in the two frameworks, but XLA rounds
each elementwise op inside gelu/silu to bf16 where torch rounds once, and
matmuls sum in other orders, so values differ by about one bf16 step in a
layer, and that compounds over a few layers.  ``BF16_TOL`` (2e-2 relative,
plus 2e-2 of the largest magnitude) is five such steps.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_configs import reference_fields
from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
BF16_TOL = 2e-2


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _assert_bf16_close(out, expect):
    expect = _np(expect)
    np.testing.assert_allclose(_np(out), expect, rtol=BF16_TOL,
                               atol=BF16_TOL * np.abs(expect).max())


def _bf16(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _to_numpy(tree):
    """JAX params as numpy, bf16 carried as float32, as convert.py takes them."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  tree)


def _jax_params(cfg):
    params, _ = JT.init_params(cfg, jax.random.PRNGKey(0))
    return params, _to_numpy(params)


# smoke configs of each package: an arch, or "arch@head_dim" for its smoke
# config with that head dim (phi3_mini_3_8b's full head dim, 96, and
# zamba2_2_7b's, 80, are off whole TMA boxes; their smoke configs' is 16);
# the moe family's two, the second with MLA; the hybrid family's zamba2;
# the encdec family's whisper and the vlm family's InternVL2
SMOKE_CASES = ["gemma3_1b", "tinyllama_1_1b", "falcon_mamba_7b",
               "phi3_mini_3_8b", "phi3_mini_3_8b@96", "granite_moe_1b_a400m",
               "deepseek_v2_lite_16b", "zamba2_2_7b", "zamba2_2_7b@80",
               "whisper_small", "internvl2_26b"]


def _stub_inputs(cfg, B, seed):
    """The stub frontends' embeddings a prefill of ``cfg`` takes beside its
    tokens, random float32 from ``seed``, as (JAX, torch) batch dicts
    without the tokens: whisper's frames, InternVL2's patches."""
    n = {"encdec": ("frames", cfg.encoder.n_ctx if cfg.encoder else 0),
         "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if n is None:
        return {}, {}
    a = np.random.default_rng(seed).standard_normal(
        (B, n[1], cfg.d_model)).astype(np.float32)
    return {n[0]: jnp.asarray(a)}, {n[0]: torch.from_numpy(a)}


def _smoke_configs(case):
    arch, _, head_dim = case.partition("@")
    cfgs = (jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch))
    if head_dim:
        cfgs = tuple(dataclasses.replace(c, head_dim=int(head_dim))
                     for c in cfgs)
    return cfgs


# ---------------------------------------------------------------------------
# configs and params


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_configs_match_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        reference = getattr(jconfigs, get)(arch)
        assert reference_fields(getattr(tconfigs, get)(arch), reference) \
            == dataclasses.asdict(reference)


def test_unported_family_raises():
    """No family is left unported: the port's registry holds the
    reference's architectures, each FULL and SMOKE config equal to the
    reference's field by field (dashed ids too), and an unknown arch
    raises ``KeyError``."""
    assert set(tconfigs.ARCH_IDS) == set(jconfigs.ARCH_IDS)
    for arch in jconfigs.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            for name in (arch, arch.replace("_", "-")):
                reference = getattr(jconfigs, get)(arch)
                assert reference_fields(getattr(tconfigs, get)(name),
                                        reference) \
                    == dataclasses.asdict(reference), name
    with pytest.raises(KeyError):
        tconfigs.get_config("nope")


@pytest.mark.parametrize("arch", SMOKE_CASES)
def test_converted_params_match_own_init(arch):
    """The converter yields the tree, shapes and dtypes of the port's own
    init, bf16 survives the float32 carry exactly, and the port's init draws
    with the reference's scales."""
    jcfg, cfg = _smoke_configs(arch)
    jparams, jnp_params = _jax_params(jcfg)
    conv = convert.params_from_jax(jnp_params)
    own = TT.init_params(cfg, seed=0, device="cpu")
    flat_conv = dict(_flatten(conv))
    flat_own = dict(_flatten(own))
    assert flat_conv.keys() == flat_own.keys()
    for key, t in flat_own.items():
        c = flat_conv[key]
        assert (c.shape, c.dtype) == (t.shape, t.dtype), key
        np.testing.assert_allclose(c.float().std().item(),
                                   t.float().std().item(), rtol=0.1,
                                   atol=1e-6, err_msg=key)
    assert np.array_equal(
        conv["embed"].view(torch.int16).numpy(),
        np.asarray(jparams["embed"]).view(np.int16))


def _flatten(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# layers and attention


def test_norms_and_rope_match_jax():
    rng = np.random.default_rng(0)
    jx, tx = _bf16(rng, 2, 4, 12, 16)
    scale = rng.standard_normal(16).astype(np.float32)
    out = TL.rmsnorm(tx, torch.from_numpy(scale))
    expect = JL.rmsnorm(jx, jnp.asarray(scale))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out), _np(expect))
    out = TL.apply_norm("layernorm", tx, torch.from_numpy(scale))
    expect = JL.apply_norm("layernorm", jx, jnp.asarray(scale))
    np.testing.assert_allclose(_np(out), _np(expect), rtol=2 ** -8, atol=1e-6)

    pos = np.arange(12)
    jcos, jsin = JL.rope_tables(jnp.asarray(pos), 16, 1e6)
    tcos, tsin = TL.rope_tables(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(_np(tcos), _np(jcos), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tsin), _np(jsin), rtol=1e-5, atol=1e-6)
    out = TL.apply_rope(tx, tcos, tsin)
    expect = JL.apply_rope(jx, jcos, jsin)
    np.testing.assert_allclose(_np(out), _np(expect), rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["geglu", "swiglu"])
def test_mlp_apply_matches_jax(activation, dtype):
    """In float32 the two agree to summation order (1e-5), which tells
    tanh-gelu from exact gelu; in bf16 to ``BF16_TOL``."""
    rng = np.random.default_rng(1)
    jdt = jnp.dtype(dtype)
    p = JL.mlp_init(jax.random.PRNGKey(1), 32, 96, activation, dtype=jdt)
    jp = {k: leaf.value for k, leaf in p.items()}
    jx, _ = _bf16(rng, 2, 5, 32)
    jx = jx.astype(jdt)
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()} \
        if dtype == "float32" else convert.tree_from_jax(_to_numpy(jp))
    out = TL.mlp_apply(tp, torch.from_numpy(_np(jx)).to(getattr(torch, dtype)),
                       activation)
    expect = JL.mlp_apply(jp, jx, activation)
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(expect), rtol=1e-5,
                                   atol=1e-5)
    else:
        _assert_bf16_close(out, expect)


@pytest.mark.parametrize("arch", ["gemma3_1b", "gemma_2b", "tinyllama_1_1b"])
def test_embed_tokens_matches_jax_exactly(arch):
    """gemma scales its embeddings by sqrt(d_model) rounded to bf16, in
    bf16; the port must round at the same place to match bit for bit.  The
    full configs' widths (1152, 2048) have no exact square root; a 16-row
    table stands in for the vocabulary."""
    d = jconfigs.get_config(arch).d_model
    table = np.random.default_rng(5).standard_normal((16, d), np.float32)
    tokens = np.random.default_rng(6).integers(0, 16, (2, 9))
    expect = JT._embed_tokens(jconfigs.get_config(arch),
                              {"embed": jnp.asarray(table, jnp.bfloat16)},
                              jnp.asarray(tokens))
    out = TT._embed_tokens(tconfigs.get_config(arch),
                           {"embed": torch.from_numpy(table).bfloat16()},
                           torch.from_numpy(tokens))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out), _np(expect))


def _attn_setup(arch, seed):
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    jp = {k: leaf.value for k, leaf in
          JA.attn_init(jax.random.PRNGKey(seed), jcfg).items()}
    return jcfg, tcfg, jp, convert.tree_from_jax(_to_numpy(jp))


@pytest.mark.parametrize("arch,window", [("gemma3_1b", 8),
                                         ("gemma3_1b", 0),
                                         ("tinyllama_1_1b", 0)])
def test_gqa_forward_matches_jax(arch, window):
    jcfg, tcfg, jp, tp = _attn_setup(arch, 2)
    rng = np.random.default_rng(2)
    S = 21
    jx, tx = _bf16(rng, 2, S, jcfg.d_model)
    jcos, jsin = JT._rope_for(jcfg, jnp.arange(S))
    tcos, tsin = TT._rope_for(tcfg, torch.arange(S))
    jout, (jk, jv) = JA.gqa_forward(jp, jx, jcos, jsin, cfg=jcfg, causal=True,
                                    window=window)
    tout, (tk, tv) = TA.gqa_forward(tp, tx, tcos, tsin, cfg=tcfg, causal=True,
                                    window=window)
    _assert_bf16_close(tout, jout)
    _assert_bf16_close(tk, jk)
    _assert_bf16_close(tv, jv)


@pytest.mark.parametrize("arch,window", [("gemma3_1b", 8),
                                         ("tinyllama_1_1b", 0)])
def test_gqa_decode_matches_jax(arch, window):
    jcfg, tcfg, jp, tp = _attn_setup(arch, 3)
    rng = np.random.default_rng(3)
    B, S, pos = 2, 24, 17
    hd, Hkv = jcfg.resolved_head_dim, jcfg.n_kv_heads
    jx, tx = _bf16(rng, B, 1, jcfg.d_model)
    jck, tck = _bf16(rng, B, Hkv, S, hd)
    jcv, tcv = _bf16(rng, B, Hkv, S, hd)
    jcos, jsin = JT._rope_for(jcfg, jnp.full((1,), pos))
    tcos, tsin = TT._rope_for(tcfg, torch.full((1,), pos))
    jout, jck, jcv = JA.gqa_decode(jp, jx, jck, jcv, jcos, jsin, cfg=jcfg,
                                   pos=jnp.asarray(pos), window=window)
    tout, tck2, tcv2 = TA.gqa_decode(tp, tx, tck, tcv, tcos, tsin, cfg=tcfg,
                                     pos=pos, window=window)
    assert tck2 is tck and tcv2 is tcv   # updated in place
    _assert_bf16_close(tout, jout)
    _assert_bf16_close(tck, jck)
    _assert_bf16_close(tcv, jcv)


# ---------------------------------------------------------------------------
# the whole slice


@pytest.mark.parametrize("arch", SMOKE_CASES)
def test_prefill_and_teacher_forced_decode_match_jax(arch):
    """Prefill logits and the filled cache (KV, or falcon_mamba_7b's conv
    tail and SSM state, or zamba2's Mamba2 conv tails and states beside its
    shared attention's KV), then 4 decode steps fed the JAX package's
    greedy tokens (free-running tokens could part at a bf16 argmax tie).
    The prompt (20) is longer than gemma3's smoke window (8), so the local
    layers' window mask is exercised, and shorter than zamba2's smoke
    chunk (32), so its SSD runs one chunk of 20.  phi3_mini_3_8b also runs
    at its full head dim, 96, and zamba2_2_7b at its, 80.  whisper's
    prompt comes with random frame embeddings (its ``xk``/``xv`` caches
    hold the encoder's keys), InternVL2's with random patch embeddings
    ahead of it, so that its decode steps sit after the patches."""
    jcfg, tcfg = _smoke_configs(arch)
    jparams, np_params = _jax_params(jcfg)
    tparams = convert.params_from_jax(np_params)
    B, n_dec = 2, 4
    S = 20 + (jcfg.n_patches if jcfg.family == "vlm" else 0)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (B, 20))
    jstub, tstub = _stub_inputs(jcfg, B, 5)
    jlog, jcache = JT.prefill_forward(
        jcfg, jparams, {"tokens": jnp.asarray(tokens, jnp.int32), **jstub},
        max_seq=S + n_dec)
    tlog, tcache = TT.prefill_forward(
        tcfg, tparams, {"tokens": torch.from_numpy(tokens), **tstub},
        max_seq=S + n_dec)
    assert tlog.shape == (B, 1, tcfg.vocab)
    _assert_bf16_close(tlog, jlog)
    assert tcache.keys() == jcache.keys()
    for key in tcache:
        assert tcache[key].shape == jcache[key].shape
        _assert_bf16_close(tcache[key], jcache[key])
    for i in range(n_dec):
        tok = np.array(jnp.argmax(jlog[:, -1], -1))[:, None]
        jlog, jcache = JT.decode_forward(jcfg, jparams, jcache,
                                         jnp.asarray(tok, jnp.int32),
                                         jnp.asarray(S + i, jnp.int32))
        tlog, tcache = TT.decode_forward(tcfg, tparams, tcache,
                                         torch.from_numpy(tok), S + i)
        _assert_bf16_close(tlog, jlog)
    for key in tcache:
        _assert_bf16_close(tcache[key], jcache[key])


def test_cpu_launcher_serves_requests(capsys):
    cfg = tconfigs.get_smoke_config("gemma3_1b")
    lines = []
    stats = tserve.serve(cfg, requests=5, batch=2, prompt_len=12, max_new=3,
                         device="cpu", log=lines.append)
    assert stats["requests"] == 5 and stats["batches"] == 3
    assert [t.shape for t in stats["tokens"]] == [(2, 3), (2, 3), (1, 3)]
    assert all(((t >= 0) & (t < cfg.vocab)).all() for t in stats["tokens"])
    assert stats["finite"] and len(stats["prefill_s"]) == 3
    assert lines[-1].startswith("served 5 requests")
    tserve.main(["--device", "cpu", "--requests", "2", "--max-new", "2"])
    assert "served 2 requests" in capsys.readouterr().out


def test_cuda_requested_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke_config("gemma3_1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(cfg, requests=1)


def test_port_imports_no_jax_and_no_reference():
    """Every module of repro_torch, chip_smoke.py and the four examples of
    examples_torch/ (by path), imported in a fresh interpreter, leave no
    jax* and no repro/repro.* module loaded."""
    code = (
        "import importlib, importlib.util, pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "for name in ('quickstart', 'train_lm', 'camera_pipeline',"
        " 'serve_batch'):\n"
        "    spec = importlib.util.spec_from_file_location("
        "name, f'examples_torch/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.startswith('jax')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert 'repro_torch.models.ssm' in mods, mods\n"
        "assert 'repro_torch.sim.engine' in mods, mods\n"
        "for m in ('sim.serving', 'serve.policy', 'apps.serving',"
        " 'launch.serve_batch', 'dist', 'dist.context', 'optim',"
        " 'optim.optimizers', 'train', 'train.step', 'data',"
        " 'data.pipeline', 'ckpt', 'ckpt.checkpoint', 'launch.train',"
        " 'core.tree', 'core.hlo', 'core.simulator', 'core.sampling',"
        " 'launch.dryrun', 'launch.perf_iter'):\n"
        "    assert 'repro_torch.' + m in mods, mods\n"
        "assert len(mods) >= 70, mods\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
