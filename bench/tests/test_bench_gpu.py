"""Each cell, cut to small sizes, run whole on the card: the program's
kernels on the timed path, the trace read, the check passing.  Skips
where there is no card."""
import pytest

import run


@pytest.mark.gpu
@pytest.mark.parametrize("workload",
                         ["phi3-prefill", "falcon-prefill", "phi3-decode"])
def test_small_cell_on_the_card(cell_of, workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    c = cell_of(workload)
    r = run.run_cell(c, 2**36 + 1, 2.0, True, "cuda")
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
    assert r["breakdown"]["device_ops"]
    assert r["correct"], r["checked"]
