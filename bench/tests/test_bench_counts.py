"""The yardstick's operation and byte counts against hand-worked shapes."""
import pytest

from yardstick import counts

PHI3 = {"model": {"family": "dense", "n_layers": 32, "d_model": 3072,
                  "n_heads": 32, "n_kv_heads": 32, "head_dim": 96,
                  "d_ff": 8192, "vocab": 32064, "activation": "swiglu"}}
FALCON = {"model": {"family": "ssm", "n_layers": 64, "d_model": 4096,
                    "vocab": 65024, "ssm": {"d_state": 16, "d_conv": 4,
                                            "expand": 2, "version": 1}}}


def test_flash_cost_by_hand():
    # 2 heads of D 4 over S 3, causal: 6 live pairs a head, 4 D = 16 a pair
    ops, nbytes = counts.flash_cost(1, 2, 1, 3, 4)
    assert ops == 16 * 6 * 2
    # q, o: 2 heads x 3 x 4; k, v: 1 head x 3 x 4; bf16
    assert nbytes == 2 * (2 * 12 * 2 + 2 * 12)


def test_flash_cost_phi3_batch():
    ops, nbytes = counts.flash_cost(8, 32, 32, 4000, 96)
    assert ops == 4 * 96 * 32 * 8 * (4000 * 4001 // 2)
    assert nbytes == 2 * 8 * 4000 * 96 * 128
    # operations bound it at 4000 (about 0.1 s of bf16 peak, 0.01 s of bytes)
    assert counts.least_seconds(ops, nbytes, "bf16") == ops / 989e12


def test_scan_cost_by_hand():
    ops, nbytes = counts.scan_cost(2, 3, 5, 4)
    assert ops == 10 * 2 * 3 * 5 * 4
    assert nbytes == 4 * (3 * 2 * 3 * 5 + 2 * 2 * 3 * 4 + 5 * 4 + 5
                          + 2 * 5 * 4)


def test_least_seconds_takes_the_larger():
    assert counts.least_seconds(989e12, 0, "bf16") == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12, "fp32") == pytest.approx(1.0)
    assert counts.least_seconds(67e12, 0, "fp32") == pytest.approx(1.0)


def test_model_flops_phi3_by_hand():
    d, ff, L, V = 3072, 8192, 32, 32064
    matrices = 2 * (4 * d * d + 3 * d * ff)
    # a prefill of 2 requests of 5 tokens: pairs 15 a head
    want = 2 * (L * (5 * matrices + 4 * 96 * 32 * 15) + 2 * d * V)
    assert counts.model_flops(PHI3, 2, 0, 5) == want
    # a decode step at position 9: 10 keys
    want = 3 * (L * (matrices + 4 * 96 * 32 * 10) + 2 * d * V)
    assert counts.model_flops(PHI3, 3, 9, 1) == want


def test_model_flops_falcon_by_hand():
    d, di, r, N, L, V = 4096, 8192, 256, 16, 64, 65024
    matrices = 2 * (d * 2 * di + di * (r + 2 * N) + r * di + di * d)
    want = L * (7 * matrices + 10 * di * N * 7) + 2 * d * V
    assert counts.model_flops(FALCON, 1, 0, 7) == want
