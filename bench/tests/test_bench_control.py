"""The control, the reference computed in float8 in the program's place,
fails the cell's limits, where the program passes them: at small sizes on
the CPU (on the card at each cell's own size: ``tools/calibrate.py``)."""
import pytest

from yardstick import check, loop, program, weights


@pytest.mark.parametrize("workload",
                         ["phi3-prefill", "falcon-prefill", "phi3-decode"])
def test_control_fails_the_limits(cell_of, workload):
    c = cell_of(workload)
    spec, traffic = c.config, c.traffic
    params = weights.make(spec, 2**32 + 77, "cpu")
    steps = program.Steps(spec)
    loop.warm(steps, params, spec, traffic, "cpu")
    w = loop.serve(steps, params, spec, traffic, 2**32 + 77, 2.0, "cpu")
    assert w.kept
    ok, shown = check.verdict(check.program_numbers(spec, params, w.kept),
                              c.limits)
    assert ok, shown
    ok, shown = check.verdict(check.control_numbers(spec, params, w.kept),
                              c.limits)
    assert not ok, shown
