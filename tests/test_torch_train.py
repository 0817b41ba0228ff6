"""The port's training slice held against the JAX package's, on the CPU:
the optimizers and schedule, the train step with microbatching, the data
pipeline, the workload shapes and the training launcher.

The reference's own cases (``tests/test_optim.py:11-45``,
``tests/test_system.py:16-45``, ``tests/test_arch_smoke.py:42``) run on the
port with their tolerances.  Beside them the port's functions take the
reference's inputs: numpy arrays from a seed, the reference's params
carried across with ``repro_torch.convert``.  Float32 arithmetic is held
at 1e-6; bf16 at ``BF16_TOL`` (see ``test_torch_serve.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.core import config as jconfig
from repro.data import pipeline as jpipe
from repro.models import transformer as JT
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as j_make_train_step
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import optim as toptim
from repro_torch.core import config as tconfig
from repro_torch.core import tree
from repro_torch.data import DataPipeline, synthetic_batch
from repro_torch.launch import train as tlaunch
from repro_torch.train import TrainConfig, init_train_state, make_train_step

BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _assert_bf16_close(out, expect):
    expect = _np(expect)
    np.testing.assert_allclose(_np(out), expect, rtol=BF16_TOL,
                               atol=BF16_TOL * np.abs(expect).max())


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# optimizers: tests/test_optim.py:11-45 on the port


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    opt = toptim.adamw_init(params)
    target = torch.tensor([1.0, 1.0, 1.0])
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, opt = toptim.adamw_update(g, opt, params, lr=5e-2,
                                          weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)
    assert int(opt["count"]) == 300


def test_sgd_momentum_minimizes():
    params = {"w": torch.tensor([4.0])}
    opt = toptim.sgd_init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, opt = toptim.sgd_update(g, opt, params, lr=1e-2)
    assert abs(float(params["w"][0])) < 1e-2


def test_cosine_schedule_shape():
    lr = toptim.cosine_schedule(1e-3, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1e-3, rel=1e-5)
    assert float(lr(100)) == pytest.approx(0.0, abs=1e-9)
    assert float(lr(5)) == pytest.approx(5e-4, rel=1e-5)


def test_grad_clip():
    g = {"a": torch.ones(4) * 10.0}
    clipped, gn = toptim.clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(20.0)
    total = float(torch.sqrt(torch.sum(clipped["a"] ** 2)))
    assert total == pytest.approx(1.0, rel=1e-5)


def test_optimizers_match_reference():
    """cosine_schedule, clip_by_global_norm and three AdamW steps (then
    three SGD steps) on the same arrays: float32 leaves within 1e-6 of the
    reference's, the bf16 leaf within one bf16 step (its float32 update is
    within 1e-6; the cast can round the other way), the moments within
    rtol 1e-5 (v sums (1 - b2) g g, rounded in another order: 3.3e-6 seen)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    j_lr = joptim.cosine_schedule(3e-2, 2, 10)
    t_lr = toptim.cosine_schedule(3e-2, 2, 10)
    for step in (0, 1, 2, 3, 7, 10, 12):
        np.testing.assert_allclose(t_lr(step), float(j_lr(step)), rtol=1e-6,
                                   atol=1e-12)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jparams["c"] = jparams["c"].astype(jnp.bfloat16)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tparams["c"] = tparams["c"].bfloat16()
    jopt, topt = joptim.adamw_init(jparams), toptim.adamw_init(tparams)
    for i, g in enumerate(grads):
        jg, jn = joptim.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, 1.0)
        tg, tn = toptim.clip_by_global_norm(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(_np(tg[k]), _np(jg[k]), rtol=1e-6,
                                       atol=1e-6)
        jparams, jopt = joptim.adamw_update(jg, jopt, jparams, lr=j_lr(i + 2))
        tparams, topt = toptim.adamw_update(tg, topt, tparams, lr=t_lr(i + 2))
        for k in ("a", "b"):
            np.testing.assert_allclose(_np(tparams[k]), _np(jparams[k]),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(tparams["c"]), _np(jparams["c"]),
                                   rtol=2 ** -8, atol=0)
        for mv in ("m", "v"):
            for k in g:
                np.testing.assert_allclose(_np(topt[mv][k]),
                                           _np(jopt[mv][k]), rtol=1e-5,
                                           atol=1e-9)
    jm, tm = joptim.sgd_init(jparams), toptim.sgd_init(tparams)
    for g in grads:
        jparams, jm = joptim.sgd_update(
            {k: jnp.asarray(v) for k, v in g.items()}, jm, jparams, lr=1e-2)
        tparams, tm = toptim.sgd_update(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, tm,
            tparams, lr=1e-2)
    for k in ("a", "b"):
        np.testing.assert_allclose(_np(tparams[k]), _np(jparams[k]),
                                   rtol=1e-6, atol=1e-6)
    assert int(tm["count"]) == int(jm["count"]) == 3


# ---------------------------------------------------------------------------
# the train step: tests/test_system.py:16-45, tests/test_arch_smoke.py:42


def test_training_reduces_loss():
    """A few steps of real training on a tiny model reduce the loss."""
    cfg = tconfigs.get_smoke_config("tinyllama_1_1b")
    params, opt = init_train_state(cfg, 0, "cpu")
    step = make_train_step(cfg, TrainConfig(lr=3e-3, warmup=2,
                                            total_steps=50))
    batch = _torch_batch(synthetic_batch(cfg, 4, 32,
                                         np.random.default_rng(0)))
    losses = []
    for i in range(12):
        params, opt, metrics = step(params, opt, batch, i)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_microbatched_step_matches_full_batch_loss():
    """The reference's bound on the NLL (0.05), and beside it the two
    steps' updated params within ``BF16_TOL`` of each other: the float32
    gradient averaged over 4 microbatches is the full batch's."""
    cfg = tconfigs.get_smoke_config("phi3_mini_3_8b")
    batch = _torch_batch(synthetic_batch(cfg, 8, 16,
                                         np.random.default_rng(0)))
    out = []
    for n in (1, 4):
        params, opt = init_train_state(cfg, 0, "cpu")
        step = make_train_step(cfg, TrainConfig(n_microbatches=n, warmup=1))
        out.append(step(params, opt, batch, 1))
    (p1, _, m1), (p2, _, m2) = out
    assert abs(float(m1["nll"]) - float(m2["nll"])) < 0.05
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]),
                               rtol=BF16_TOL)
    for a, b in zip(tree.leaves(p1), tree.leaves(p2)):
        _assert_bf16_close(b, a)


def test_data_pipeline_prefetch():
    cfg = tconfigs.get_smoke_config("tinyllama_1_1b")
    pipe = DataPipeline(cfg, batch=2, seq=16, n_workers=2, prefetch=2)
    try:
        seen = [next(pipe) for _ in range(4)]
        assert all(b["tokens"].shape == (2, 16) for b in seen)
        assert all((b["tokens"] >= 0).all() and
                   (b["tokens"] < cfg.vocab).all() for b in seen)
    finally:
        pipe.stop()


def _batch(cfg, B=2, S=16):
    """tests/test_arch_smoke.py's batch, as numpy."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_one_train_step(arch):
    cfg = tconfigs.get_smoke_config(arch)
    params, opt = init_train_state(cfg, 0, "cpu")
    before = [p.detach().clone() for p in tree.leaves(params)]
    step = make_train_step(cfg, TrainConfig(lr=1e-3, warmup=1,
                                            total_steps=10))
    params2, opt2, metrics = step(params, opt, _torch_batch(_batch(cfg)), 1)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    moved = sum(float((a.float() - b.float()).abs().sum())
                for a, b in zip(tree.leaves(params2), before))
    assert moved > 0
    assert int(opt2["count"]) == 1


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "granite_moe_1b_a400m"])
def test_train_step_matches_reference(arch):
    """One step of each package from the same params and batch, in 2
    microbatches: the metrics within ``BF16_TOL`` (granite adds the MoE
    terms), and every updated param within 2.5 lr of the reference's.
    AdamW's first step moves each element by about lr sign(g), so where a
    gradient element is near 0 the two packages' bf16 gradients can part
    in sign: such elements, and only a few (under 1%), part by up to 2 lr.
    """
    jcfg, tcfg = jconfigs.get_smoke_config(arch), \
        tconfigs.get_smoke_config(arch)
    jparams, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jparams))
    b = _batch(jcfg, B=4)
    kw = dict(lr=1e-3, warmup=1, total_steps=10, n_microbatches=2)
    jstep = jax.jit(j_make_train_step(jcfg, JTrainConfig(**kw)))
    jp2, _, jm = jstep(jparams, joptim.adamw_init(jparams),
                       {k: jnp.asarray(v) for k, v in b.items()},
                       jnp.asarray(1, jnp.int32))
    tstep = make_train_step(tcfg, TrainConfig(**kw))
    tp2, _, tm = tstep(tparams, toptim.adamw_init(tparams), _torch_batch(b),
                       1)
    for key in ("loss", "nll", "zloss", "moe_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=BF16_TOL, atol=1e-6, err_msg=key)
    jflat = convert.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp2))
    lr = float(jm["lr"])
    for (key, t), j in zip(tree.flatten(tp2).items(), tree.leaves(jflat)):
        assert t.dtype == j.dtype, key
        t, j = _np(t), _np(j)
        np.testing.assert_allclose(t, j, rtol=0, atol=2.5 * lr, err_msg=key)
        parted = np.abs(t - j) > BF16_TOL * np.abs(j).max()
        assert parted.mean() < 0.01, (key, parted.mean())


# ---------------------------------------------------------------------------
# data, shapes


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "whisper_small",
                                  "internvl2_26b"])
def test_synthetic_batch_equals_reference(arch):
    for seed in (0, 7):
        a = synthetic_batch(tconfigs.get_smoke_config(arch), 3, 24,
                            np.random.default_rng(seed))
        b = jpipe.synthetic_batch(jconfigs.get_smoke_config(arch), 3, 24,
                                  np.random.default_rng(seed))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_shapes_match_reference():
    assert [dataclasses.asdict(s) for s in tconfig.SHAPES] == \
        [dataclasses.asdict(s) for s in jconfig.SHAPES]
    assert tconfig.SHAPE_BY_NAME.keys() == jconfig.SHAPE_BY_NAME.keys()
    for arch in tconfigs.ARCH_IDS:
        for ts, js in zip(tconfig.SHAPES, jconfig.SHAPES):
            assert tconfig.cell_is_runnable(tconfigs.get_config(arch), ts) \
                == jconfig.cell_is_runnable(jconfigs.get_config(arch), js)
            assert ts.is_decode == js.is_decode


# ---------------------------------------------------------------------------
# the launcher


def test_resume_continues_the_uninterrupted_run(tmp_path):
    """Two steps with a checkpoint each step, then a resumed third step:
    its loss and params equal those of three steps run at once (on the
    CPU, bit for bit)."""
    cfg = tconfigs.get_smoke_config("tinyllama_1_1b")
    kw = dict(batch=2, seq=16, device="cpu", log=lambda *a: None)
    whole = tlaunch.train(cfg, steps=3, **kw)
    tlaunch.train(cfg, steps=2, ckpt_dir=str(tmp_path), ckpt_every=1, **kw)
    lines = []
    resumed = tlaunch.train(cfg, steps=3, ckpt_dir=str(tmp_path),
                            resume=True, **dict(kw, log=lines.append))
    assert lines[0] == "[restore] resumed at step 2"
    assert resumed["start"] == 2 and len(resumed["losses"]) == 1
    assert resumed["losses"][0] == whole["losses"][2]
    for a, b in zip(tree.leaves(resumed["params"]),
                    tree.leaves(whole["params"])):
        assert torch.equal(a, b)
    assert int(resumed["opt"]["count"]) == 3


def test_cli_smoke_resumes_at_the_next_step(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    tlaunch.main(["--smoke", "--device", "cpu", "--steps", "3",
                  "--ckpt-every", "1", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out
    assert "step 0 loss=" in out and "step 2 loss=" in out
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("step_*")) == \
        ["step_0000000001", "step_0000000002"]
    tlaunch.main(["--smoke", "--device", "cpu", "--steps", "4",
                  "--ckpt-dir", ckpt, "--resume"])
    out = capsys.readouterr().out
    assert "[restore] resumed at step 3" in out and "step 3 loss=" in out
    # the reference's error on a world too small for the multi-pod mesh
    with pytest.raises(RuntimeError, match="need 512 devices, have 1"):
        tlaunch.main(["--device", "cpu", "--multi-pod"])


def test_cli_smoke_installs_and_clears_a_mesh(monkeypatch):
    """``--smoke`` trains on a (1, 1) host mesh with ``rules_for``'s rules
    installed, its losses bit for bit those of no mesh, and clears both,
    and the world-1 process group it started, afterwards."""
    import torch.distributed as dist
    from repro_torch.dist import context as dist_ctx
    from repro_torch.dist import sharding
    seen = []
    train = tlaunch.train

    def spy(cfg, **kw):
        mesh, rules = dist_ctx.get_mesh(), sharding.active_rules()
        seen.append((dict(zip(mesh.mesh_dim_names, mesh.shape)),
                     rules.mesh is mesh, rules.table["batch"]))
        return train(cfg, **kw)
    monkeypatch.setattr(tlaunch, "train", spy)
    out = tlaunch.main(["--smoke", "--device", "cpu", "--steps", "2"])
    assert seen == [({"data": 1, "model": 1}, True, None)]
    assert dist_ctx.get_mesh() is None and sharding.active_rules() is None
    assert not dist.is_initialized()
    alone = train(tconfigs.get_smoke_config("tinyllama_1_1b"), batch=4,
                  seq=64, steps=2, device="cpu", log=lambda *a: None)
    assert out["losses"] == alone["losses"]


@pytest.mark.parametrize("world, entry", [(2, "data"), (8, None)])
def test_cli_smoke_shards_its_own_batch(tmp_path, world, entry):
    """Under ``torchrun``, ``--smoke``'s rules are those of the batch it
    trains (4 x 64), not of the shape it is cut from (train_4k's 256 x
    4096): 2 ranks each take half of it, and 8 ranks, which 4 rows do not
    divide, each take all of it; either way the losses are one process's
    (within the bf16 data-parallel step's 2e-2)."""
    import _torch_dist
    ranks = _torch_dist.spawn(_torch_dist.rank_smoke_cli, world, tmp_path, 2)
    alone = tlaunch.train(tconfigs.get_smoke_config("tinyllama_1_1b"), batch=4,
                  seq=64, steps=2, device="cpu", log=lambda *a: None)
    for seen, losses in ranks:
        assert seen == [entry]
        assert losses == ranks[0][1]
        assert losses == pytest.approx(alone["losses"], rel=2e-2)


def test_embedding_gradient_sums_each_row_in_float32():
    """The embedding's gradient sums a token's rows in float32 and rounds
    once: bit for bit a float32 sum cast to bf16, however often a token
    occurs."""
    from repro_torch.models import transformer as TT
    gen = torch.Generator().manual_seed(0)
    embed = torch.randn(50, 8, generator=gen).to(torch.bfloat16)
    embed.requires_grad_(True)
    tokens = torch.tensor([[1, 1, 1, 7, 1, 3], [1, 7, 1, 1, 1, 0]])
    g = torch.randn(2, 6, 8, generator=gen).to(torch.bfloat16)
    out = TT._Gather.apply(embed, tokens)
    assert torch.equal(out, embed.detach()[tokens])
    out.backward(g)
    expect = torch.zeros(50, 8).index_put_(
        (tokens.reshape(-1),), g.reshape(-1, 8).float(), accumulate=True)
    assert embed.grad.dtype == torch.bfloat16
    assert torch.equal(embed.grad, expect.to(torch.bfloat16))


def test_cuda_requested_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke_config("tinyllama_1_1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.train(cfg, batch=2, seq=8, steps=1)
