"""Shared by ``tests/test_torch_train_grads*.py``: the port's ``loss_fn``
and the gradient of every param leaf held against ``jax.value_and_grad`` of
``repro.models.transformer.loss_fn``, on the CPU, for one arch's SMOKE
config; and by ``tests/test_torch_tp_step*.py``: the train step over a
``model`` axis, each rank's metrics and gradient shards, held against the
same (``check_tp_against_reference``).

Inputs are ``tests/test_arch_smoke.py``'s batch, made with numpy; the
reference's params go through ``repro_torch.convert``.

- float32: both packages' params cast to float32, and their embedding's
  bf16 cast lifted (``_embed_tokens`` returns float32 in both) so that no
  activation rounds to bf16 (the reference's scan carries the embedding's
  type and refuses float32 blocks behind a bf16 embedding).  Loss within
  1e-5, every leaf's relative L2 error within 1e-4.  whisper_small is not
  held in float32: its encoder casts its input to bf16 inside the
  reference's scan, which then refuses float32 blocks.
- bf16: the params as each package makes them.  Loss within ``BF16_TOL``
  (2e-2) and every leaf's relative L2 error within 3e-2: XLA rounds each
  elementwise op to bf16 where torch rounds once (``test_torch_serve.py``),
  and the backward doubles the rounded ops (2.5e-2 seen at most).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import tree
from repro_torch.models import transformer as TT

BF16_TOL = 2e-2
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": BF16_TOL}


def cases(archs):
    """(arch, dtype) of ``archs`` in both types, but whisper_small in bf16
    only (see the module docstring)."""
    return [(arch, dtype) for arch in archs
            for dtype in ("float32", "bfloat16")
            if (arch, dtype) != ("whisper_small", "float32")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _jax_embed_f32(cfg, p, tokens, pos_offset=0):
    """The reference's ``_embed_tokens`` without its final bf16 cast."""
    x = p["embed"][tokens]
    if cfg.family == "encdec":
        x = x + jax.lax.dynamic_slice_in_dim(p["pos"], pos_offset,
                                             tokens.shape[1], 0)[None]
    if cfg.family in ("dense", "vlm", "moe") and cfg.name.startswith("gemma"):
        x = x * (cfg.d_model ** 0.5)
    return x


def _torch_embed_f32(cfg, p, tokens, offset=0):
    """The port's ``_embed_tokens`` without its final bf16 cast."""
    x = p["embed"][tokens]
    if cfg.family == "encdec":
        x = x + p["pos"][offset:offset + tokens.shape[1]]
    if cfg.name.startswith("gemma"):
        x = x * cfg.d_model ** 0.5
    return x


def _reference_grads(jcfg, jp, batch):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                       for k, v in batch.items()}),
        has_aux=True)(jp)
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                               grads)


def _reference_leaf(flat, key):
    """The reference's gradient of the port's leaf ``key``: the port's
    ``layers/<i>/...`` is row i of the reference's stacked
    ``layers/...``."""
    parts = key.split("/")
    for stack in ("layers", "encoder/layers"):
        n = stack.count("/") + 1
        if "/".join(parts[:n]) == stack:
            return flat["/".join([stack] + parts[n + 1:])][int(parts[n])]
    return flat[key]


def check_loss_and_grads(arch, dtype, monkeypatch):
    jcfg, tcfg = jconfigs.get_smoke_config(arch), \
        tconfigs.get_smoke_config(arch)
    jp, _ = JT.init_params(jcfg, jax.random.PRNGKey(0))
    if dtype == "float32":
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
        monkeypatch.setattr(JT, "_embed_tokens", _jax_embed_f32)
        monkeypatch.setattr(TT, "_embed_tokens", _torch_embed_f32)
    b = _batch(jcfg)
    jloss, jmetrics, jgrads = _reference_grads(jcfg, jp, b)
    tp = convert.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp))
    if dtype == "float32":
        tp = tree.map_tree(lambda t: t.float(), tp)
    leaves = tree.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = TT.loss_fn(tcfg, tp, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_TOL[dtype])
    for key in ("nll", "zloss", "moe_loss"):
        np.testing.assert_allclose(metrics[key].item(), jmetrics[key],
                                   rtol=LOSS_TOL[dtype], atol=1e-7,
                                   err_msg=key)
    flat = {}

    def walk(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = v
    walk(jgrads)
    for (key, t), g in zip(tree.flatten(tp).items(), grads):
        assert g.dtype == t.dtype, key
        expect = _reference_leaf(flat, key)
        got = g.float().numpy()
        err = np.linalg.norm(got - expect) / max(np.linalg.norm(expect),
                                                 1e-30)
        assert err <= GRAD_TOL[dtype], (key, err)


def params_to_jax(tparams):
    """The reference's params as float32 arrays from the port's: the
    inverse of ``convert.params_from_jax`` (the blocks stacked again)."""
    def arr(t):
        return jnp.asarray(t.detach().float().numpy())

    def plain(d):
        return {k: plain(v) if isinstance(v, dict) else arr(v)
                for k, v in d.items()}

    def stack(blocks):
        return {k: stack([b[k] for b in blocks])
                if isinstance(blocks[0][k], dict)
                else jnp.stack([arr(b[k]) for b in blocks])
                for k in blocks[0]}
    out = plain({k: v for k, v in tparams.items()
                 if k not in ("layers", "encoder")})
    out["layers"] = stack(tparams["layers"])
    if "encoder" in tparams:
        enc = tparams["encoder"]
        out["encoder"] = {"layers": stack(enc["layers"]), **plain(
            {k: v for k, v in enc.items() if k != "layers"})}
    return out


def check_tp_against_reference(arch, ranks, tparams, batch, monkeypatch):
    """The float32 train step over a ``model`` axis (``ranks``:
    ``_torch_dist.rank_tp_step``'s results, each rank's local gradients
    and the split dimension of each leaf) against ``jax.value_and_grad``
    of the reference's ``loss_fn`` on the same params (the port's
    ``tparams`` in float32, ``params_to_jax``) and ``batch`` (numpy):
    ``loss``, ``nll``, ``zloss`` and ``moe_loss`` within ``LOSS_TOL``, and
    every rank's gradient shard against the slice of the reference's
    gradient at ``GRAD_TOL`` (relative L2), in float32 with the
    embedding's bf16 cast lifted in both, as ``check_loss_and_grads``.
    Returns the largest gradient error."""
    jcfg = jconfigs.get_smoke_config(arch)
    monkeypatch.setattr(JT, "_embed_tokens", _jax_embed_f32)
    jloss, jmetrics, jgrads = _reference_grads(
        jcfg, params_to_jax(tparams), batch)
    flat = {}

    def walk(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = v
    walk(jgrads)
    worst = 0.0
    for r in ranks:
        got = r[torch.float32]
        np.testing.assert_allclose(got["metrics"]["loss"], jloss,
                                   rtol=LOSS_TOL["float32"])
        for key in ("nll", "zloss", "moe_loss"):
            np.testing.assert_allclose(got["metrics"][key], jmetrics[key],
                                       rtol=LOSS_TOL["float32"], atol=1e-7,
                                       err_msg=key)
        keys = list(tree.flatten(tparams))
        assert len(keys) == len(got["grads"])
        for key, g in zip(keys, got["grads"]):
            expect = _reference_leaf(flat, key)
            d = got["dims"][key]
            if d is not None:
                n, i = g.shape[d], got["model_index"]
                expect = np.take(expect, range(i * n, (i + 1) * n), axis=d)
            assert g.shape == expect.shape, key
            got_g = g.float().numpy()
            err = np.linalg.norm(got_g - expect) / max(
                np.linalg.norm(expect), 1e-30)
            assert err <= GRAD_TOL["float32"], (key, err)
            worst = max(worst, err)
    return worst
