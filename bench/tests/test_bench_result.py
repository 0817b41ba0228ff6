"""A whole run of each cell, cut to CPU sizes: the result line's keys, its
metrics, and the check passing the program."""
import json

import pytest

import run

CELLS = ["phi3-prefill", "falcon-prefill", "phi3-decode"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line(cell_of, workload, trace):
    c = cell_of(workload)
    r = run.run_cell(c, 2**33 + 17, 2.5, bool(trace), "cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"] \
        + (["breakdown"] if trace else []) + ["checked"]
    assert list(r) == keys
    json.dumps(r)
    wanted = c.per_layer if trace else c.end_to_end
    assert set(r["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in wanted}
    for v in r["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["checked"]) == {"gap", "logits", "cache"}
    assert r["correct"], r["checked"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "phi3-prefill", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_fewer_cards_than_asked(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(run.NoCard):
        run.require_cards(1)


def test_same_seed_same_inputs(cell_of):
    import torch
    from yardstick import traffic as mix
    t = cell_of("phi3-prefill").traffic
    a, b = mix.batches(t, 256, 2**35 + 1, "cpu"), \
        mix.batches(t, 256, 2**35 + 1, "cpu")
    for _ in range(4):
        x, y = next(a), next(b)
        assert x.prompt_len == y.prompt_len and x.check_slots == y.check_slots
        assert torch.equal(x.tokens, y.tokens)


def test_every_seed_runs_the_same_work(cell_of):
    from yardstick import traffic as mix
    t = cell_of("phi3-prefill").traffic
    cycle = sorted(int(s) for s, m in t["prompt_cycle"].items()
                   for _ in range(m))
    n = len(cycle)
    for seed in (3, 2**31 + 9):
        it = mix.lengths(t, seed)
        lengths = [next(it) for _ in range(3 * n)]
        for k in range(3):
            assert sorted(lengths[k * n:(k + 1) * n]) == cycle


def test_tpot_tail_takes_every_step():
    """A stall in one decode step of ten shows in the tail in full; the
    prefills are not decode steps."""
    from yardstick import cell as cells
    read = cells.reader("tpot_p95_ms", "end_to_end")
    units = [{"kind": "decode", "call": float(i),
              "end": i + (0.5 if i % 10 == 0 else 0.08)} for i in range(100)]
    units.append({"kind": "prefill", "call": 0.0, "end": 9.0})
    assert read({"units": units}) == pytest.approx(500.0)
