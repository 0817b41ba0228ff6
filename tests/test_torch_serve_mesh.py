"""The serving steps on the rules' shards (``serve.step`` with a mesh and
rules installed) held against one process's steps on the whole batch, on
the CPU: gloo ranks (``_torch_dist.spawn``) run the prefill and 4 decode
steps teacher-forced on the same tokens, at SMOKE widths.

  * every arch on a (data 1, model 2) mesh, in bf16 and float32 (whisper
    in bf16 only: its encoder casts to bf16).  gemma3_1b's and gemma_2b's
    single KV head cannot split over ``model``, so their caches split
    ``head_dim`` (the partial q.k summed over ``model``); tinyllama's and
    internvl2's two KV heads split;
  * tinyllama_1_1b, gemma3_1b, zamba2_2_7b and deepseek_v2_lite_16b at
    batch 1 on (data 2, model 1): the batch cannot split, so the caches
    split ``kv_seq`` over ``data`` (flash-decoding);
  * granite_moe_1b_a400m at batch 4 on (2, 2): the batch over ``data``,
    the experts over ``model``;
  * gemma3_1b under ``PerfFlags.windowed_attention`` (a local layer's
    decode reads only its window's slice of the cache) on both splits;
  * the float32 mesh logits of gemma3_1b's ``head_dim`` split,
    deepseek_v2_lite_16b's MLA and zamba2_2_7b's Mamba2 on (1, 2), and of
    tinyllama_1_1b's ``kv_seq`` split on (2, 1), held directly against the
    JAX package's serving on the same params and tokens.

Bounds are ``tests/test_torch_tp_step.py``'s: the logits of every step
within 2e-2 (bf16) and 1e-4 (float32) of one process's, relative to their
largest magnitude.  Each
rank's cache shard is held against one process's slice of the cache: the
bf16 leaves (keys and values, conv inputs) at 2e-2 in both runs, since
one process and the ranks round their float32 values to bf16 apart (one
bf16 step is 2^-8 of the value); the float32 leaves (the Mamba states) at
2e-2 in bf16 and 1e-3 in float32, since their decode steps read the bf16
conv cache.  In float32 the greedy tokens of every step are one
process's, ``==``.  A MoE arch's ranks take one process's expert choices
in bf16 (``_torch_dist.forced_experts``), as in
``tests/test_torch_tp_step_families.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_grads
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import transformer as T

STEPS = 4
PROMPT = 8
TP = [(arch, dtype) for arch in ARCH_IDS
      for dtype in (torch.bfloat16, torch.float32)
      if (arch, dtype) != ("whisper_small", torch.float32)]
SEQ = ["tinyllama_1_1b", "gemma3_1b", "zamba2_2_7b", "deepseek_v2_lite_16b"]
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# a float32 cache leaf (the Mamba states) of a float32 run: its decode
# steps read the bf16 conv cache, whose roundings one process and the ranks
# flip apart (falcon_mamba_7b's SMOKE ssm state: 3.5e-4 after 4 steps)
CACHE_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_process(arch, dtype, B, prompt=PROMPT, window=False,
                conv_f32=False):
    """One process's run, and the experts its MoE chose (None without
    MoE, or in float32)."""
    cfg = get_smoke_config(arch)
    params = _torch_dist.cast(T.init_params(cfg, 1, "cpu"), dtype)
    with _torch_dist.captured_experts() as chosen, \
            _torch_dist.windowed(window), _torch_dist.conv_cache_f32(conv_f32):
        out = _torch_dist.serve_run(cfg, params, B, prompt, STEPS, dtype)
    routes = list(chosen) if cfg.moe is not None \
        and dtype == torch.bfloat16 else None
    return out, routes


def _mesh_case(cases, shape, tmp_path_factory, name, prompt=PROMPT,
               window=False, conv_f32=False):
    singles = {(a, d, B): one_process(a, d, B, prompt, window, conv_f32)
               for a, d, B in cases}
    ranks = _torch_dist.spawn(
        _torch_dist.rank_serve, shape[0] * shape[1],
        tmp_path_factory.mktemp(name),
        [(a, d, B, prompt, STEPS, singles[(a, d, B)][1])
         for a, d, B in cases], shape, window, conv_f32, timeout=180)
    return {k: v[0] for k, v in singles.items()}, ranks


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    return _mesh_case([(a, d, 2) for a, d in TP], (1, 2), tmp_path_factory,
                      "tp")


@pytest.fixture(scope="module")
def seq_runs(tmp_path_factory):
    return _mesh_case([(a, torch.float32, 1) for a in SEQ], (2, 1),
                      tmp_path_factory, "seq")


@pytest.fixture(scope="module")
def mamba2_f32_runs(tmp_path_factory):
    """zamba2_2_7b in float32 on (1, 2) with its ``conv`` cache in float32
    (``test_mesh_logits_match_the_reference``)."""
    return _mesh_case([("zamba2_2_7b", torch.float32, 2)], (1, 2),
                      tmp_path_factory, "mamba2_f32", conv_f32=True)


@pytest.fixture(scope="module")
def dp_ep_runs(tmp_path_factory):
    return _mesh_case([("granite_moe_1b_a400m", d, 4)
                       for d in (torch.bfloat16, torch.float32)], (2, 2),
                      tmp_path_factory, "dp_ep")


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def check(single, ranks, key):
    """Every rank's logits, tokens and cache shards against one
    process's."""
    arch, dtype, _ = key
    logits, tokens, cache = single
    tol = TOL[dtype]
    for r in ranks:
        got = r[key]
        assert len(got["logits"]) == STEPS + 1
        for i, (a, b) in enumerate(zip(got["logits"], logits)):
            assert a.shape == b.shape, (arch, i)
            assert _rel(a, b) <= tol, (arch, dtype, i, _rel(a, b))
        if dtype == torch.float32:
            for a, b in zip(got["tokens"], tokens):
                assert torch.equal(a, b), arch
        assert set(got["cache"]) == set(cache)
        for name, (local, offsets) in got["cache"].items():
            want = cache[name]
            for d, (o, n) in enumerate(zip(offsets, local.shape)):
                want = want.narrow(d, o, n)
            assert local.dtype == want.dtype, name
            leaf_tol = CACHE_TOL if local.dtype == torch.float32 \
                and dtype == torch.float32 else 2e-2
            assert _rel(local, want) <= leaf_tol, \
                (arch, dtype, name, _rel(local, want))
    return ranks[0][key]["table"]


@pytest.mark.parametrize("arch,dtype", TP,
                         ids=[f"{a}-{str(d)[6:]}" for a, d in TP])
def test_serve_over_model_matches_one_process(tp_runs, arch, dtype):
    singles, ranks = tp_runs
    key = (arch, dtype, 2)
    table = check(singles[key], ranks, key)
    assert table["vocab"] == "model"
    cfg = get_smoke_config(arch)
    if cfg.family != "ssm":
        assert table["heads_x_dim"] == "model"


@pytest.mark.parametrize("arch", ("gemma3_1b", "gemma_2b"))
def test_mqa_cache_splits_head_dim(tp_runs, arch):
    """One KV head cannot split over ``model`` 2: the rules split the
    cache's ``head_dim``, and each rank holds half of it."""
    singles, ranks = tp_runs
    key = (arch, torch.float32, 2)
    cfg = get_smoke_config(arch)
    assert ranks[0][key]["table"]["head_dim"] == "model"
    for r in ranks:
        local, offsets = r[key]["cache"]["k"]
        assert local.shape[2] == cfg.n_kv_heads == 1
        assert local.shape[4] * 2 == cfg.resolved_head_dim
    assert {r[key]["cache"]["k"][1][4] for r in ranks} \
        == {0, cfg.resolved_head_dim // 2}


@pytest.mark.parametrize("arch", SEQ)
def test_kv_seq_split_matches_one_process(seq_runs, arch):
    singles, ranks = seq_runs
    key = (arch, torch.float32, 1)
    table = check(singles[key], ranks, key)
    assert table["batch"] is None and table["kv_seq"] == "data"
    name = "ckv" if arch.startswith("deepseek") else "k"
    dim = 2 if name == "ckv" else 3
    starts = sorted(r[key]["cache"][name][1][dim] for r in ranks)
    assert starts[0] == 0 and starts[1] > 0


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32),
                         ids=("bf16", "f32"))
def test_batch_over_data_experts_over_model(dp_ep_runs, dtype):
    singles, ranks = dp_ep_runs
    key = ("granite_moe_1b_a400m", dtype, 4)
    table = check(singles[key], ranks, key)
    assert table["batch"] == "data" and table["experts"] == "model"


def test_greedy_vocab_parallel_ties_go_to_the_lowest_index(tmp_path):
    """Equal maxima on both ranks' shards, and within one: the token is the
    lowest index, as ``argmax`` picks on the whole row."""
    rows = torch.tensor([[0., 3., 1., 3., 3., 0., 2., 3.],
                         [5., 0., 0., 0., 0., 0., 5., 0.],
                         [0., 0., 0., 1., 0., 9., 9., 0.]])
    got = _torch_dist.spawn(_torch_dist.rank_greedy, 2, tmp_path, rows)
    want = torch.argmax(rows, -1)[:, None]
    for r in got:
        assert torch.equal(r, want)


@pytest.mark.parametrize("shape,B,prompt", (((1, 2), 2, PROMPT),
                                            ((2, 1), 1, 16)),
                         ids=("head_dim", "kv_seq"))
def test_static_window_decode_on_the_rules_shards(tmp_path_factory, shape,
                                                  B, prompt):
    """Under ``PerfFlags.windowed_attention`` gemma3_1b's local layers
    (window 8) read only the window's slice of the cache, on the mesh as
    in one process.  On (1, 2) the slice is of the ``head_dim`` split
    cache.  On (2, 1) each rank takes the part of the slice in its
    positions: with a prompt of 16 the ranks hold 10 positions each, and
    from the second step on rank 0 holds none of the window, so the
    flash-decoding combines an empty slice with the other rank's."""
    key = ("gemma3_1b", torch.float32, B)
    singles, ranks = _mesh_case([key], shape, tmp_path_factory, "window",
                                prompt=prompt, window=True)
    table = check(singles[key], ranks, key)
    assert table["head_dim" if shape[1] > 1 else "kv_seq"] is not None


def _jax_embed_decode_f32(cfg, p, tokens, pos):
    """The reference's ``_embed_tokens_decode`` without its final bf16
    cast (no encdec arch is held here)."""
    x = p["embed"][tokens]
    if cfg.family in ("dense", "vlm", "moe") and cfg.name.startswith("gemma"):
        x = x * (cfg.d_model ** 0.5)
    return x


REFERENCE = (("gemma3_1b", "tp_runs", 2),
             ("deepseek_v2_lite_16b", "tp_runs", 2),
             ("zamba2_2_7b", "mamba2_f32_runs", 2),
             ("tinyllama_1_1b", "seq_runs", 1))


@pytest.mark.parametrize("arch,runs,B", REFERENCE,
                         ids=[a for a, _, _ in REFERENCE])
def test_mesh_logits_match_the_reference(request, monkeypatch, arch, runs,
                                         B):
    """The float32 mesh runs' logits (the prefill's and every teacher-forced
    decode step's) held directly against the JAX package's
    ``prefill_forward`` and ``decode_forward`` (what its ``serve.step``
    runs) on the same params (``_torch_grads.params_to_jax``) and tokens,
    the embedding's bf16 cast lifted in both, at 1e-4 of their largest
    magnitude: the ``head_dim`` split's summed partial q.k (gemma3_1b),
    MLA's compressed cache (deepseek_v2_lite_16b) and the Mamba2 states on
    the rank's heads (zamba2_2_7b) on (1, 2), and the flash-decoding of
    the ``kv_seq`` split (tinyllama_1_1b) on (2, 1).

    zamba2's ``conv`` cache is float32 in both packages here (both make it
    bf16).  In a float32 run the reference's Mamba2 decode returns it in
    float32 (its ``conv1d_step`` concatenates the bf16 state with the
    float32 input, and ``lax.scan`` carries the result), while the port
    rounds each new column into its bf16 cache: one process's logits part
    from the reference's by 1.4-2.2e-3 from the second decode step on, and
    by at most 5.2e-5 with the cache float32 in both."""
    _, ranks = request.getfixturevalue(runs)
    cfg, jcfg = get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    if cfg.ssm is not None:
        init = JT.init_cache

        def init_f32(*args, **kw):
            cache, axes = init(*args, **kw)
            return dict(cache, conv=cache["conv"].astype(jnp.float32)), axes
        monkeypatch.setattr(JT, "init_cache", init_f32)
    monkeypatch.setattr(JT, "_embed_tokens", _torch_grads._jax_embed_f32)
    monkeypatch.setattr(JT, "_embed_tokens_decode", _jax_embed_decode_f32)
    jp = _torch_grads.params_to_jax(T.init_params(cfg, 1, "cpu"))
    toks, forced = _torch_dist.serve_inputs(cfg, B, PROMPT, STEPS)
    jlog, cache = JT.prefill_forward(
        jcfg, jp, {"tokens": jnp.asarray(toks.numpy(), jnp.int32)},
        max_seq=PROMPT + STEPS)
    want = [jlog]
    for i in range(STEPS):
        jlog, cache = JT.decode_forward(
            jcfg, jp, cache, jnp.asarray(forced[:, i:i + 1].numpy(),
                                         jnp.int32),
            jnp.asarray(PROMPT + i, jnp.int32))
        want.append(jlog)
    want = [torch.from_numpy(np.asarray(w, np.float32)) for w in want]
    for r in ranks:
        got = r[(arch, torch.float32, B)]["logits"]
        assert len(got) == len(want) == STEPS + 1
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape, (arch, i)
            assert _rel(a, b) <= TOL[torch.float32], (arch, i, _rel(a, b))
