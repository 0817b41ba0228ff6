"""What a run imports holds no module of JAX or of the JAX package,
compared by whole top-level names (the port's ``repro_torch`` begins with
the package's ``repro``); and the benchmark does without the program only
by failing."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parents[2]

PROBE = r"""
import json, sys
sys.path.insert(0, {bench!r})
import run
run.environment()
from yardstick import cell as cells, check, loop, program, trace, weights
for w in cells.benchmark()["workloads"]:
    c = cells.find(w["name"])
    program.Steps(c.config)
    check.family(c.config)
print(json.dumps(run.banned_modules()))
"""


def test_a_cell_s_imports_load_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=str(ROOT / "bench"))],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_banned_names_are_compared_whole(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "repro_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", sys)
    assert "repro" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "repro.sub", sys)
    assert "repro" in run.banned_modules()


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys; sys.path.insert(0, 'bench'); import run; "
            "run.require_cards = lambda n: None; "
            "sys.exit(run.main(['--workload', 'phi3-prefill', '--seed', "
            "'1', '--seconds', '1', '--trace', '0']))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
