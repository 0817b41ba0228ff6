"""The train step over a ``model`` axis (tensor parallelism on the rules'
shards) held against one process's step on the whole batch, on the CPU:
the dense and vlm archs' SMOKE configs on a (data 1, model 2) mesh of gloo
ranks (``_torch_dist.spawn``), in bf16 and float32.

Every leaf's updated shard, AdamW's ``m`` and ``v`` and the gradient
handed to the clip are held against one process's slice; ``loss``,
``nll``, ``zloss``, ``moe_loss`` and ``grad_norm`` against one process's.
Bounds as ``test_torch_pipeline.py::test_data_parallel_step_matches_one_rank``:
2e-2 a metric and 3e-2 relative L2 a leaf in bf16 (the row-parallel
products sum bf16 partials over the ranks), 1e-4 in float32; each updated
shard within one step of its dtype of AdamW's step from the rank's own
``m`` and ``v`` (``_torch_dist.adamw_first_step``: a missed or
sign-flipped update is off by lr or 2 lr), and within 2.5 lr plus one
step of its dtype of one process's (AdamW's first step moves an element
by about lr, either sign where its gradient is near 0).
Each rank holds only its shard of a split leaf, and the rules split the
arch's heads, ``d_ff`` and vocab.  One process's step is itself held
against ``jax.value_and_grad`` of the reference in
``tests/test_torch_train_grads*.py``, and the float32 ranks' metrics and
gradient shards of tinyllama_1_1b and internvl2_26b are held against it
directly (``_torch_grads.check_tp_against_reference``).
"""
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_grads
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic_batch
from repro_torch.models import transformer as T

ARCHS = ("gemma3_1b", "tinyllama_1_1b", "gemma_2b", "phi3_mini_3_8b",
         "internvl2_26b")
DTYPES = (torch.bfloat16, torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """arch -> (cfg, ranks, one process), each arch spawned once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = get_smoke_config(arch)
            params = T.init_params(cfg, 1, "cpu")
            batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
                cfg, 4, 16, np.random.default_rng(3)).items()}
            cache[arch] = (cfg, *_torch_dist.tp_case(
                cfg, params, batch, (1, 2), DTYPES,
                tmp_path_factory.mktemp(arch)), params, batch)
        return cache[arch]
    return get


@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_one_process(runs, arch, dtype):
    cfg, ranks, single, _, _ = runs(arch)
    tol, grad_tol = (2e-2, 3e-2) if dtype == torch.bfloat16 \
        else (1e-4, 1e-4)
    _, split = _torch_dist.assert_tp_matches(ranks, single[dtype], dtype, 2,
                                             tol, grad_tol)
    dims = ranks[0][dtype]["dims"]
    assert _torch_dist.split_axes(cfg, dims) \
        >= _torch_dist.expected_split(cfg)
    assert split == {k for k, d in dims.items() if d is not None}
    assert sorted(r[dtype]["model_index"] for r in ranks) == [0, 1]


@pytest.mark.parametrize("arch", ("tinyllama_1_1b", "internvl2_26b"))
def test_tp_step_matches_the_reference(runs, arch, monkeypatch):
    """The float32 ranks against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` on the same params and batch: the metrics at 1e-5 and each
    gradient shard at 1e-4 relative L2 of the reference's slice."""
    cfg, ranks, _, params, batch = runs(arch)
    _torch_grads.check_tp_against_reference(
        arch, ranks, _torch_dist.cast(params, torch.float32),
        {k: v.numpy() for k, v in batch.items()}, monkeypatch)
