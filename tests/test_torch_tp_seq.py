"""``PerfFlags.seq_sharded_residual`` in the train step over a ``model``
axis, on the CPU: the residual stream sharded on the sequence over
``model`` between blocks (each region's entry an all-gather, its exit a
reduce-scatter), where the reference constrains it to ``("batch",
"seq_model", None)``.  On (data 1, model 2) the step with the flag gives
the losses, gradients, moments and params of the step without it, and of
one process, at ``test_torch_tp_step.py``'s bounds; the flag's run makes
more reduce-scatters than the run without.  The dense, moe (expert
parallelism on the gathered tokens), ssm, encdec and vlm families; the
reference applies the constraint in neither the hybrid family nor
whisper's encoder, and the port follows it.
"""
import numpy as np
import pytest
import torch

import _torch_dist
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic_batch
from repro_torch.dist.context import PerfFlags
from repro_torch.models import transformer as T

ARCHS = ("tinyllama_1_1b", "granite_moe_1b_a400m", "falcon_mamba_7b",
         "whisper_small", "internvl2_26b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_sharded_residual_matches_the_step_without(tmp_path, arch):
    cfg = get_smoke_config(arch)
    dtype = torch.bfloat16 if arch == "whisper_small" else torch.float32
    params = T.init_params(cfg, 1, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(
        cfg, 4, 16, np.random.default_rng(3)).items()}
    single = _torch_dist.one_process(cfg, params, batch, (dtype,))[dtype]
    ranks = _torch_dist.spawn(
        _torch_dist.rank_tp_flags, 2, tmp_path, cfg, params, batch,
        (PerfFlags(), PerfFlags(seq_sharded_residual=True)), (dtype,),
        timeout=120)
    tol, grad_tol = (2e-2, 3e-2) if dtype == torch.bfloat16 \
        else (1e-4, 1e-4)
    for i in (0, 1):
        _torch_dist.assert_tp_matches([r[i] for r in ranks], single, dtype,
                                      2, tol, grad_tol)
    for off, on in ranks:
        off, on = off[dtype], on[dtype]
        # the regions' exits: beyond the reduce-scatters of the leaves
        # gathered at use (Mamba1's in_proj), which both runs make
        assert on["collectives"].get("_reduce_scatter", 0) \
            > off["collectives"].get("_reduce_scatter", 0)
        for key in ("loss", "nll", "zloss", "moe_loss", "grad_norm"):
            assert abs(on["metrics"][key] - off["metrics"][key]) \
                <= tol * abs(off["metrics"][key]) + 1e-6, key
        for g, e in zip(on["grads"], off["grads"]):
            assert _torch_dist._rel_l2(g, e) <= grad_tol
