"""The harness finds each cell's configuration, mix, limits and metric
readers by name, and BENCHMARK.json keeps the contract's shape."""
import json
import re

import pytest

from yardstick import cell as cells
from yardstick import check

B = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(B) == KEYS
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024
    assert B["command"] == ["python3", "bench/run.py"]
    assert B["paths"] == ["bench"]


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries(section, keys):
    names = [e["name"] for e in B[section]]
    assert len(names) == len(set(names))
    for e in B[section]:
        assert set(e) == keys
        assert NAME.match(e["name"])
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metrics(section):
    base = {"name", "unit", "better", "source"} | (
        {"bound"} if section == "end_to_end" else {"layer", "moves"})
    for m in B[section]:
        assert set(m) - {"workloads"} == base
        assert section == "end_to_end" or m["workloads"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))


def test_bounds():
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("workload", [w["name"] for w in B["workloads"]])
def test_cell_found_by_name(workload):
    c = cells.find(workload)
    assert c.config["name"] == next(w["config"] for w in B["workloads"]
                                    if w["name"] == workload)
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
    for name in e2e + [m["name"] for m in c.per_layer]:
        assert name == "setup_s" or callable(c.readers[name])
    assert set(c.limits) >= set(check.NUMBERS)
    for v in (c.limits[k] for k in check.NUMBERS):
        assert v["lower"] is None or v["lower"] < v["limit"]
        assert v["upper"] is None or v["limit"] < v["upper"]


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        cells.find("no-such-cell")


def test_config_files_are_paths_of_their_own():
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("bench/configs/")
        spec = json.loads((cells.ROOT / f).read_text())
        assert spec["reduced"] == next(c["reduced"] for c in B["configs"]
                                       if c["file"] == f)
