"""The benchmark's param maker against the program's param tree."""
import pytest
import torch

from yardstick import cell as cells
from yardstick import program, weights


@pytest.mark.parametrize("config", [c["name"] for c in
                                    cells.benchmark()["configs"]])
def test_leaves_match_init_params_at_full_size(config):
    spec = cells.load_json(cells.ROOT / f"bench/configs/{config}.json")
    want = program.init_params_shapes(spec)
    got = {p: (tuple(s), d) for p, s, d, _ in weights.leaves(spec)}
    assert got == want


@pytest.mark.parametrize("workload", ["phi3-prefill", "falcon-prefill"])
def test_make_is_the_seed_s(cell_of, workload):
    spec = cell_of(workload).config
    a = weights.make(spec, 2**40 + 3, "cpu")
    b = weights.make(spec, 2**40 + 3, "cpu")
    c = weights.make(spec, 2**40 + 4, "cpu")
    fa, fb, fc = (dict(program_flat(t)) for t in (a, b, c))
    assert fa.keys() == fb.keys() == set(program.init_params_shapes(spec))
    for k in fa:
        assert torch.equal(fa[k], fb[k])
        assert torch.isfinite(fa[k].float()).all()
    assert not torch.equal(fa["embed"], fc["embed"])
    assert fa["embed"].dtype == torch.bfloat16


def program_flat(tree):
    from repro_torch.core import tree as T
    return T.flatten(tree).items()
