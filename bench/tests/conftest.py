"""The benchmark's tests: ``bench/`` and ``src/`` on the path, and small
stand-ins for the cells' configurations and mixes, so that a whole run
fits a CPU test."""
import copy
import sys
from pathlib import Path

import pytest
import torch

# a few threads a test process: under xdist, torch's default of one thread
# a core in every worker slows a small model's step a hundredfold
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "bench", ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

SMALL_MODEL = {
    "phi3_mini_3_8b": {"n_layers": 2, "d_model": 64, "n_heads": 4,
                       "n_kv_heads": 4, "head_dim": 16, "d_ff": 192,
                       "vocab": 256},
    # deep enough that float8's rounding accumulates as at full depth
    "falcon_mamba_7b": {"n_layers": 16, "d_model": 128, "vocab": 256,
                        "ssm": {"d_state": 8, "d_conv": 4, "expand": 2,
                                "version": 1}},
}
SMALL_TRAFFIC = {
    "prefill_pool": {"batch": 4, "prompt_cycle": {"16": 2, "40": 1},
                     "check_slots": 2, "check_batches": 3,
                     "trace": {"first_unit": 1, "units": 2}},
    "long_decode": {"batch": 4, "prompt_cycle": {"24": 1}, "max_new": 6,
                    "max_seq": 30, "check_slots": 3,
                    "trace": {"first_unit": 2, "units": 2}},
}


def small_cell(name):
    """The cell ``name`` of BENCHMARK.json with its files, its model and
    mix cut to CPU sizes; its limits, readers and metrics as they are."""
    from yardstick import cell as cells
    c = copy.deepcopy(cells.find(name))
    c.config["model"].update(SMALL_MODEL[c.config["name"]])
    mix = next(w["traffic"] for w in cells.benchmark()["workloads"]
               if w["name"] == name)
    c.traffic.update(SMALL_TRAFFIC[mix])
    return c


@pytest.fixture
def cell_of():
    return small_cell
