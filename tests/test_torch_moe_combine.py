"""The dropless MoE's combine, ``kernels.ops.moe_combine``, on the CPU.

On the CPU ``ops`` runs the plain version, which is the chain
``models.moe._combine`` ran in plain torch before the kernel: held here bit
for bit against that chain, written out below, on inputs from a real
dispatch (``models.moe._sorted_rows``) at k from 1 to 8, at widths off the
16-byte vector and with an expert that gets no rows.  The kernel's own
arithmetic, the float32 sum in routing order
(``chip_smoke.routing_order_sum``), is held within the summation-order
slack of the plain version (``chip_smoke.combine_err``) that the card's
tests hold the kernel to.  The kernel wrapper refuses other types, shapes,
k above ``K_MAX``, non-contiguous inputs and CPU tensors, with no launch.
The card's path is taken here with the kernel replaced by the plain
version: ``_moe_dropless`` and a prefill through it equal the CPU path.
``tests/test_torch_gpu.py`` holds the kernel against the plain version on
the card.
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.config import ModelConfig
from repro_torch.kernels import moe_combine as mo
from repro_torch.kernels import ops, ref
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import (combine_err, combine_inputs,  # noqa: E402
                        routing_order_sum)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread here, so that the suite's timing tests on the
    other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (tokens, k, d, experts, the expert no token chooses)
CASES = [(37, 6, 64, 8, None), (50, 1, 64, 4, None), (29, 8, 40, 8, None),
         (33, 3, 37, 6, 2), (12, 2, 2048, 64, 0), (1, 6, 13, 8, None)]


def _inputs(T, k, d, n_experts, empty, seed=0):
    return combine_inputs(T, k, d, n_experts,
                          torch.Generator().manual_seed(seed), empty)


def _old_combine(y, w, order, token, T):
    """``models.moe._combine`` as it ran before the kernel: the gates in
    sorted order, a float32 ``index_add_`` of gate x row into its token."""
    gates = w.reshape(-1)[order]
    out = torch.zeros(T, y.shape[1], dtype=torch.float32, device=y.device)
    return out.index_add_(0, token, y.float() * gates[:, None])


def _order(inv):
    """The sort ``inv`` inverts: the assignment at each sorted place."""
    return torch.argsort(inv.reshape(-1).long())


@pytest.mark.parametrize("T,k,d,n_experts,empty", CASES)
def test_plain_combine_is_the_old_chain(T, k, d, n_experts, empty):
    y, w, inv = _inputs(T, k, d, n_experts, empty)
    assert inv.dtype == torch.int32 and inv.shape == (T, k)
    order = _order(inv)
    old = _old_combine(y, w, order, order // k, T)
    got = ops.moe_combine(y, w, inv)
    assert got.dtype == torch.bfloat16 and got.shape == (T, d)
    assert torch.equal(got.view(torch.int16),
                       old.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(ref.moe_combine_ref(y.float(), w, inv), old)


@pytest.mark.parametrize("T,k,d,n_experts,empty", CASES)
def test_sorted_rows_gives_the_inverse_of_the_stable_sort(T, k, d, n_experts,
                                                          empty):
    """Each assignment's place in the expert-sorted rows: the row there is
    its token's, the experts ascend, each expert's tokens in token order,
    and ``ends`` closes each expert's group (an empty expert's group is
    empty)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(T, d, generator=gen).to(torch.bfloat16)
    logits = torch.randn(T, n_experts, generator=gen)
    if empty is not None:
        logits[:, empty] = -torch.inf
    idx = logits.topk(k, -1).indices
    inv, ends, rows = TM._sorted_rows(x, idx, n_experts)
    flat = inv.reshape(-1).long()
    assert torch.equal(torch.sort(flat).values, torch.arange(T * k))
    assert torch.equal(rows[inv.long()], x[:, None].expand(T, k, d))
    experts = torch.empty(T * k, dtype=torch.long)
    experts[flat] = idx.reshape(-1)
    tokens = torch.empty(T * k, dtype=torch.long)
    tokens[flat] = torch.arange(T * k) // k
    key = experts * T + tokens
    assert bool((key[1:] > key[:-1]).all())
    assert torch.equal(ends.long(), torch.cumsum(
        torch.bincount(idx.reshape(-1), minlength=n_experts), 0))
    if empty is not None:
        assert int(ends[empty]) == (int(ends[empty - 1]) if empty else 0)


@pytest.mark.parametrize("T,k,d,n_experts,empty", CASES)
def test_routing_order_sum_is_within_the_stated_slack(T, k, d, n_experts,
                                                      empty):
    """The kernel's arithmetic, the float32 sum in routing order, differs
    from the plain version's sorted order by summation order alone: within
    one bf16 ulp plus 2 k float32 units of the products' magnitudes."""
    y, w, inv = _inputs(T, k, d, n_experts, empty, seed=2)
    expect = ref.moe_combine_ref(y, w, inv)
    assert combine_err(routing_order_sum(y, w, inv), expect, y, w, inv) <= 1


def test_combine_err_sees_a_dropped_assignment():
    """One assignment's row left out of a token reads far above 1."""
    y, w, inv = _inputs(37, 6, 64, 8, None, seed=3)
    expect = ref.moe_combine_ref(y, w, inv)
    w_cut = w.clone()
    w_cut[5, 5] = 0
    assert combine_err(ref.moe_combine_ref(y, w_cut, inv), expect, y, w,
                       inv) > 10


def _refusals():
    y, w, inv = _inputs(6, 3, 16, 4, None, seed=4)
    return {
        "y float32": ((y.float(), w, inv), TypeError, "bfloat16"),
        "w bf16": ((y, w.to(torch.bfloat16), inv), TypeError, "float32"),
        "inv int64": ((y, w, inv.long()), TypeError, "int32"),
        "y 1-d": ((y.reshape(-1), w, inv), ValueError, "takes y"),
        "inv of another shape": ((y, w, inv[:, :2]), ValueError, "takes y"),
        "y of other rows": ((y[:-3], w, inv), ValueError, "takes y"),
        "empty y": ((y[:, :0], w, inv), ValueError, "takes y"),
        "k above the maximum": (
            (torch.zeros(2 * (mo.K_MAX + 1), 16, dtype=torch.bfloat16),
             torch.zeros(2, mo.K_MAX + 1),
             torch.zeros(2, mo.K_MAX + 1, dtype=torch.int32)),
            ValueError, "k of 1"),
        "y not contiguous": ((y.t().contiguous().t(), w, inv), ValueError,
                             "contiguous"),
        "w not contiguous": ((y, w.t().contiguous().t(), inv), ValueError,
                             "contiguous"),
        "on the CPU": ((y, w, inv), ValueError, "CUDA"),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_moe_combine_wrapper_refuses(case):
    args, err, match = _refusals()[case]
    before = mo.moe_combine.launches
    with pytest.raises(err, match=match):
        mo.moe_combine(*args)
    assert mo.moe_combine.launches == before


def test_moe_combine_wrapper_refuses_grad():
    y, w, inv = _inputs(6, 3, 16, 4, None, seed=5)
    with pytest.raises(RuntimeError, match="requires grad"):
        mo.moe_combine(y, w.requires_grad_(), inv)


# ---------------------------------------------------------------------------
# the card's path, the kernel replaced by the plain version

MODEL = {"name": "dropless_small", "family": "moe", "n_layers": 2,
         "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "d_ff": 48,
         "vocab": 256, "activation": "swiglu", "rope_theta": 10_000.0,
         "moe": {"n_experts": 8, "top_k": 3, "n_shared": 1,
                 "d_ff_expert": 48, "norm_topk_prob": False,
                 "dropless": True},
         "mla": {"kv_lora_rank": 32, "q_lora_rank": 0, "qk_nope_dim": 16,
                 "qk_rope_dim": 8, "v_head_dim": 16}}


def _card_path(monkeypatch, seen):
    """``ops`` sends the combine's CPU tensors down the card's path with
    the kernel replaced by the plain version, recording each call's inputs;
    the other kernels keep the CPU's plain versions."""
    def kernel(y, w, inv):
        seen.append((y.dtype, w.dtype, inv.dtype, tuple(inv.shape)))
        return ref.moe_combine_ref(y, w, inv)
    monkeypatch.setattr(mo, "moe_combine", kernel)
    monkeypatch.setattr(ops, "_dispatch", lambda name, plain, kern, device,
                        *args, **kw: (kern if name == "moe_combine"
                                      else plain)(*args, **kw))


@pytest.mark.parametrize("top_k,d_model", [(3, 64), (1, 64), (8, 40)])
def test_moe_dropless_on_the_card_path_equals_the_cpu_path(monkeypatch,
                                                            top_k, d_model):
    cfg = ModelConfig(**{**MODEL, "d_model": d_model,
                         "moe": {**MODEL["moe"], "top_k": top_k}})
    gen = torch.Generator().manual_seed(6)
    p = TM.moe_init(gen, cfg)
    x = torch.randn(2, 21, d_model, generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        expect, _ = TM.moe_apply(p, x, cfg)
        seen = []
        _card_path(monkeypatch, seen)
        got, _ = TM.moe_apply(p, x, cfg)
    assert seen == [(torch.bfloat16, torch.float32, torch.int32,
                     (42, top_k))]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), expect.view(torch.int16))


def test_prefill_on_the_card_path_combines_once_a_layer(monkeypatch):
    cfg = ModelConfig(**MODEL)
    params = TT.init_params(cfg, 0, "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 19),
                           generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        expect, _ = TT.prefill_forward(cfg, params, {"tokens": tokens})
        seen = []
        _card_path(monkeypatch, seen)
        got, cache = TT.prefill_forward(cfg, params, {"tokens": tokens})
    assert len(seen) == cfg.n_layers
    assert torch.equal(got, expect)
    assert torch.isfinite(got).all() and cache
