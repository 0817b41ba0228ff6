"""The MLA + MoE family (deepseek_v2_lite_16b, the cell dsv2lite-prefill):
its param maker's leaves, its counts by hand, and planted faults of the
published model's mechanisms, each failing the check at a small size on
the CPU: an expert's rows dropped, the top-k gates renormalised, YaRN's
softmax factor left out."""
import copy

import pytest

import run
from repro_torch.models import attention as TA
from repro_torch.models import moe as TM
from yardstick import cell as cells
from yardstick import counts_mla_moe as C
from yardstick import program, weights

WORKLOAD = "dsv2lite-prefill"
# deep enough, and with experts enough a token, that a dropped expert's
# error accumulates in the cache as at full depth
SMALL = {"n_layers": 8, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
         "d_ff": 48, "vocab": 256,
         "moe": {"n_experts": 16, "top_k": 4, "n_shared": 1,
                 "d_ff_expert": 48, "norm_topk_prob": False,
                 "dropless": True},
         "mla": {"kv_lora_rank": 32, "q_lora_rank": 0, "qk_nope_dim": 16,
                 "qk_rope_dim": 8, "v_head_dim": 16}}
TRAFFIC = {"batch": 4, "prompt_cycle": {"16": 2, "40": 1},
           "check_slots": 2, "check_batches": 3,
           "trace": {"first_unit": 1, "units": 2}}
SPEC = cells.load_json(cells.ROOT / "bench/configs/deepseek_v2_lite_16b.json")


def small_cell():
    """The cell with its model and mix cut to CPU sizes (every published
    option kept: dropless, the gates, YaRN), its limits as they are."""
    c = copy.deepcopy(cells.find(WORKLOAD))
    c.config["model"].update(copy.deepcopy(SMALL))
    c.traffic.update(TRAFFIC)
    return c


def test_leaves_match_init_params_small():
    spec = small_cell().config
    want = program.init_params_shapes(spec)
    assert {p: (tuple(s), d) for p, s, d, _ in weights.leaves(spec)} == want
    assert program.Steps(spec).cfg.moe.dropless


def test_published_options_reach_the_program():
    cfg = program.model_config(SPEC)
    assert cfg.moe.dropless and not cfg.moe.norm_topk_prob
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.n_shared) == (64, 6, 2)
    assert cfg.rope_scaling.factor == 40
    assert cfg.rope_scaling.mscale_all_dim == 0.707


def test_model_flops_by_hand():
    d, H, L, V = 2048, 16, 27, 102400
    proj = d * H * 192 + d * 576 + 512 * H * 256 + H * 128 * d
    assert proj == 13_762_560
    matrices = 2 * (proj + 8 * 3 * d * 1408 + d * 64)
    # a prefill of 2 requests of 5 tokens: 15 live pairs a head, 640 each
    want = 2 * (L * (5 * matrices + 640 * H * 15) + 2 * d * V)
    assert C.model_flops(SPEC, 2, 0, 5) == want
    # a decode step at position 9: 10 keys
    want = 3 * (L * (matrices + 640 * H * 10) + 2 * d * V)
    assert C.model_flops(SPEC, 3, 9, 1) == want


def test_mla_flash_cost_by_hand():
    # 2 heads over S 3, q/k width 4, v width 2: 6 live pairs a head,
    # 2 x 4 + 2 x 2 = 12 operations a pair
    ops, nbytes = C.mla_flash_cost(1, 2, 3, 4, 2)
    assert ops == 12 * 6 * 2
    # q, k at 4 and v, o at 2, 2 heads x 3 positions, bf16
    assert nbytes == 2 * 3 * 2 * (4 + 4 + 2 + 2)


def test_experts_cost_by_hand():
    # 10 rows, d 4, f 3, 2 experts: 6 d f a row
    ops, nbytes = C.experts_cost(10, 4, 3, 2)
    assert ops == 6 * 4 * 3 * 10
    # stacks 3 x 2 x 4 x 3; rows in and out 2 x 10 x 4; the intermediate
    # out and in 2 x 10 x 3; bf16
    assert nbytes == 2 * (72 + 80 + 60)


def _drop_expert_0(gate, up, down, rows, ends):
    y = _grouped_ffn(gate, up, down, rows, ends).clone()
    y[:int(ends[0])] = 0
    return y


_grouped_ffn = TM._grouped_ffn
_route = TM._route
FAULTS = {
    "expert_dropped": (TM, "_grouped_ffn", _drop_expert_0),
    "gates_renormalised": (TM, "_route",
                           lambda x, r, E, k, norm=True: _route(x, r, E, k)),
    "softmax_factor_missing": (TA, "yarn_softmax_factor", lambda s: 1.0),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(monkeypatch, fault):
    module, name, broken = FAULTS[fault]
    monkeypatch.setattr(module, name, broken)
    r = run.run_cell(small_cell(), 2**34 + 5, 1.0, False, "cpu")
    assert not r["correct"], r["checked"]


def test_unbroken_is_correct():
    r = run.run_cell(small_cell(), 2**34 + 5, 1.0, False, "cpu")
    assert r["correct"], r["checked"]
