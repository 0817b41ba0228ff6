"""The train step over a ``model`` axis held against one process's step
on the whole batch, on the CPU, for the ssm, moe, hybrid and encdec
archs' SMOKE configs on a (data 1, model 2) mesh of gloo ranks, in bf16
and float32 (whisper_small in bf16 only: its encoder casts to bf16, as
``tests/_torch_grads.py`` says).  What is held, and at which bounds, as in
``test_torch_tp_step.py``; the hybrid family's bf16 leaves at 1e-1,
zamba2's card-against-CPU bound (``chip_smoke.HYBRID_GRAD_TOL``).

These are the families whose layers carry the traps of tensor
parallelism: Mamba1's ``in_proj`` (x and z side by side) and Mamba2's
fused ``in_proj``/``conv_w``/``conv_b`` are gathered at use, Mamba1's
row-parallel ``x_proj`` is summed inside the block, MLA's ``kv_a`` and
``kv_norm`` are every rank's whole with their gradients summed, the MoE's
experts are split (expert parallelism under autograd) and its router is
not.  In bf16 a MoE arch's ranks take one process's expert choices
(``_torch_dist.forced_experts``): a rounding of a row-parallel sum can
flip a near-tie between experts (granite's SMOKE: 0.23 relative L2 on its
own routing).  The float32 ranks of falcon_mamba_7b, granite_moe_1b_a400m
and deepseek_v2_lite_16b are also held against ``jax.value_and_grad`` of
the reference directly (``_torch_grads.check_tp_against_reference``).
"""
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_grads
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic_batch
from repro_torch.models import transformer as T

ARCHS = ("falcon_mamba_7b", "granite_moe_1b_a400m", "deepseek_v2_lite_16b",
         "zamba2_2_7b", "whisper_small")
CASES = [(arch, dtype) for arch in ARCHS
         for dtype in (torch.bfloat16, torch.float32)
         if (arch, dtype) != ("whisper_small", torch.float32)]


def _dtypes(arch):
    return tuple(d for a, d in CASES if a == arch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = get_smoke_config(arch)
            params = T.init_params(cfg, 1, "cpu")
            batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
                cfg, 4, 16, np.random.default_rng(3)).items()}
            cache[arch] = (cfg, *_torch_dist.tp_case(
                cfg, params, batch, (1, 2), _dtypes(arch),
                tmp_path_factory.mktemp(arch)), params, batch)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch, dtype", CASES, ids=[
    f"{a}-{'bf16' if d == torch.bfloat16 else 'f32'}" for a, d in CASES])
def test_tp_step_matches_one_process(runs, arch, dtype):
    cfg, ranks, single, _, _ = runs(arch)
    if dtype == torch.float32:
        tol = grad_tol = 1e-4
    else:
        tol, grad_tol = 2e-2, 1e-1 if cfg.family == "hybrid" else 3e-2
    _torch_dist.assert_tp_matches(ranks, single[dtype], dtype, 2, tol,
                                  grad_tol)
    assert _torch_dist.split_axes(cfg, ranks[0][dtype]["dims"]) \
        >= _torch_dist.expected_split(cfg)


def test_fused_leaves_are_stored_in_the_reference_layout(runs):
    """The gathered-at-use leaves stay the rules' contiguous shards, the
    layout the checkpoint and ``convert`` keep: rank 0's half of Mamba1's
    ``in_proj`` is x (the first d_inner columns), all of it."""
    cfg, ranks, single, _, _ = runs("falcon_mamba_7b")
    key = "layers/0/ssm/in_proj"
    d_in = cfg.ssm.expand * cfg.d_model
    for r in ranks:
        got = r[torch.float32]
        assert got["dims"][key] == 1
        start = got["model_index"] * d_in
        torch.testing.assert_close(
            got["params"][key],
            single[torch.float32][2][key][:, start:start + d_in])


@pytest.mark.parametrize("arch", ("falcon_mamba_7b", "granite_moe_1b_a400m",
                                  "deepseek_v2_lite_16b"))
def test_tp_step_matches_the_reference(runs, arch, monkeypatch):
    """The float32 ranks against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` on the same params and batch: the metrics at 1e-5 and each
    gradient shard at 1e-4 relative L2 of the reference's slice."""
    cfg, ranks, _, params, batch = runs(arch)
    _torch_grads.check_tp_against_reference(
        arch, ranks, _torch_dist.cast(params, torch.float32),
        {k: v.numpy() for k, v in batch.items()}, monkeypatch)
