"""Shared by ``tests/test_torch_train_grads*.py``: the port's ``loss_fn``
and the gradient of every param leaf held against ``jax.value_and_grad`` of
``repro.models.transformer.loss_fn``, on the CPU, for one arch's SMOKE
config.

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
