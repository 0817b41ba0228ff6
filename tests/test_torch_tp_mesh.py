"""The train step on a (data 2, model 2) mesh, world 4: data and tensor
parallelism together, held against one process's step on the whole batch
on the CPU, with and without 2 microbatches, for tinyllama_1_1b and
granite_moe_1b_a400m (expert parallelism on the ``model`` ranks, the
routing of the global batch on the data ranks).  What is held, and at
which bounds, as in ``test_torch_tp_step.py``.
"""
import numpy as np
import pytest
import torch

import _torch_dist
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic_batch
from repro_torch.models import transformer as T

DTYPES = (torch.bfloat16, torch.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(arch, microbatches):
        if (arch, microbatches) not in cache:
            cfg = get_smoke_config(arch)
            params = T.init_params(cfg, 1, "cpu")
            batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
                cfg, 4, 16, np.random.default_rng(3)).items()}
            cache[arch, microbatches] = (cfg, *_torch_dist.tp_case(
                cfg, params, batch, (2, 2), DTYPES,
                tmp_path_factory.mktemp(f"{arch}_{microbatches}"),
                microbatches))
        return cache[arch, microbatches]
    return get


@pytest.mark.parametrize("dtype", DTYPES, ids=("bf16", "f32"))
@pytest.mark.parametrize("arch, microbatches", [
    ("tinyllama_1_1b", 1), ("tinyllama_1_1b", 2),
    ("granite_moe_1b_a400m", 1), ("granite_moe_1b_a400m", 2)])
def test_data_and_model_parallel_step_matches_one_process(
        runs, arch, microbatches, dtype):
    cfg, ranks, single = runs(arch, microbatches)
    tol, grad_tol = (2e-2, 3e-2) if dtype == torch.bfloat16 \
        else (1e-4, 1e-4)
    _torch_dist.assert_tp_matches(ranks, single[dtype], dtype, 2, tol,
                                  grad_tol)
    assert _torch_dist.split_axes(cfg, ranks[0][dtype]["dims"]) \
        >= _torch_dist.expected_split(cfg)
    # the two data ranks of one model index hold the same shards
    by_model = {}
    for r in ranks:
        by_model.setdefault(r[dtype]["model_index"], []).append(r[dtype])
    assert sorted(by_model) == [0, 1]
    for a, b in by_model.values():
        for key, t in a["params"].items():
            assert torch.equal(t, b["params"][key]), key
