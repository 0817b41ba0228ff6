"""The port's sampled simulation (``repro_torch.core.sampling``) held
against the JAX package's ``repro.core.sampling`` with ``==``: every case
of ``tests/test_sampling.py`` on both packages, and ``model_loop_tree`` for
every arch at every shape kind (the loop tree's structure and its sampled
and unsampled costs).  Both are pure Python and do the same float
operations in the same order, so no tolerance is needed."""
import pytest

from _hyp import given, settings, st
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_config
from repro.core import sampling as jsampling
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import sampling as tsampling


def _tree(node):
    return (node.name, node.trips, node.body_cost, node.sampled_trips,
            node.sampled_cost(), node.unsampled_cost(),
            [_tree(c) for c in node.children])


def test_unsample_linear_exact():
    fn = lambda n: 7e-6 + n * 3e-4          # noqa: E731
    node = tsampling.measure_sampled(fn, trips=1000, sample=2)
    assert tsampling.sampling_error(tsampling.unsample(node), fn(1000)) < 1e-9
    assert _tree(node) == _tree(jsampling.measure_sampled(fn, 1000, 2))


@given(startup=st.floats(0, 1e-3), per=st.floats(1e-6, 1e-2),
       trips=st.integers(2, 10_000), sample=st.integers(1, 64))
@settings(max_examples=60, deadline=None)
def test_unsample_property(startup, per, trips, sample):
    fn = lambda n: startup + n * per        # noqa: E731
    node = tsampling.measure_sampled(fn, trips=trips, sample=sample)
    ref = jsampling.measure_sampled(fn, trips=trips, sample=sample)
    assert _tree(node) == _tree(ref)
    assert tsampling.unsample(node) == jsampling.unsample(ref)
    if sample >= 2:
        assert tsampling.sampling_error(tsampling.unsample(node),
                                        fn(trips)) < 1e-6
    assert tsampling.sampling_error(1.5, 2.0) \
        == jsampling.sampling_error(1.5, 2.0)


def test_nested_tree():
    def tree(m):
        return m.LoopNode("step", trips=1, children=[
            m.LoopNode("layers", trips=22, body_cost=2e-3, children=[
                m.LoopNode("chunks", trips=8, body_cost=1e-3)])])
    assert abs(tsampling.unsample(tree(tsampling))
               - 22 * (2e-3 + 8e-3)) < 1e-12
    assert _tree(tree(tsampling)) == _tree(tree(jsampling))


def test_sampling_factor():
    def tree(m):
        return m.LoopNode("run", trips=1, children=[
            m.LoopNode("iters", trips=100, body_cost=1.0, sampled_trips=2)])
    assert abs(tree(tsampling).sampling_factor() - 50.0) < 1e-9
    assert tree(tsampling).sampling_factor() \
        == tree(jsampling).sampling_factor()


def test_arch_lists_agree():
    assert sorted(ARCH_IDS) == sorted(REF_ARCH_IDS)


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_loop_tree(arch, kind):
    for kw in ({}, {"n_chunks": 8, "n_microbatches": 4}):
        got = tsampling.model_loop_tree(get_config(arch), kind, **kw)
        want = jsampling.model_loop_tree(ref_config(arch), kind, **kw)
        assert _tree(got) == _tree(want)
