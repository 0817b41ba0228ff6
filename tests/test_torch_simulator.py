"""The port's ``core.simulator`` and HLO lowering (``sim.ir.from_hlo``,
``sim.sweep.lower_hlo``) held against the JAX package's with ``==``.

The port's defaults are one H100 (the simulator prices at its dense bf16
peak), so its side runs at the reference's TPU v5e constants passed
explicitly: the ``EngineConfig`` fields that default from ``hw``
(:data:`V5E`) and the host floor (``host_s``, or the module's
``HOST_OVERHEAD_S`` where ``breakdown`` adds it).  The cases are
``tests/test_dist.py::test_simulator_roofline_terms``, the
``core.simulator`` cases of ``tests/test_sim_engine.py``, ``model_flops``
for every arch x shape, and ``tests/test_sweep.py``'s ``HLO`` cases.  The
engine is numpy in both packages and does the same float operations, so
every result is compared with ``==``.
"""
import dataclasses
import importlib

import pytest

from repro.configs import get_config as ref_config
from repro.core import simulator as jsim
from repro.core.config import SHAPES as REF_SHAPES
from repro.sim import engine as jengine
from repro.sim import hw as jhw
from repro.sim import ir as jir
from repro.sim import sweep as jsweep_fn  # noqa: F401  (the package export)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import simulator as tsim
from repro_torch.core.config import SHAPE_BY_NAME, SHAPES
from repro_torch.sim import engine as tengine
from repro_torch.sim import hw as thw
from repro_torch.sim import ir as tir
from repro_torch.sim.sweep import clear_caches, lower_hlo, sweep

HW_FIELDS = {"peak_flops": "PEAK_FLOPS", "hbm_bw": "HBM_BW",
             "vmem_bw": "VMEM_BW", "ici_bw": "ICI_BW",
             "ici_lat_s": "ICI_LAT_S", "node_bw": "NODE_BW",
             "node_lat_s": "NODE_LAT_S", "inter_bw": "INTER_BW",
             "inter_lat_s": "INTER_LAT_S"}
V5E = {field: getattr(jhw, const) for field, const in HW_FIELDS.items()}
HLO = {"flops": 1e15, "dot_flops": 9e14, "bytes": 1e12,
       "collective_bytes": 1e10, "wire_bytes": 1.5e10,
       "transcendentals": 1e9, "collectives": {}, "n_while": 1,
       "custom_calls": {}}
OP_FIELDS = ("name", "flops", "dot_flops", "bytes_in", "bytes_out",
             "collective_bytes", "wire_bytes", "transcendentals", "deps",
             "phase", "device_class")


def v5e():
    return tengine.EngineConfig(**V5E)


@pytest.fixture
def v5e_host(monkeypatch):
    """The port's ``breakdown`` adds the reference's host floor."""
    monkeypatch.setattr(tsim, "HOST_OVERHEAD_S", jhw.HOST_OVERHEAD_S)


def test_simulator_roofline_terms():
    """``tests/test_dist.py::test_simulator_roofline_terms`` on the port."""
    hlo = {"flops": 1e15, "dot_flops": 9e14, "bytes": 1e12,
           "collective_bytes": 1e10, "collectives": {}, "n_while": 1,
           "custom_calls": {}}
    shape = SHAPE_BY_NAME["train_4k"]
    rl = tsim.roofline(hlo, get_config("tinyllama_1_1b"), shape, 256,
                       host_s=jhw.HOST_OVERHEAD_S, config=v5e())
    assert rl.compute_s == pytest.approx(1e15 / 197e12)
    assert rl.memory_s == pytest.approx(1e12 / 819e9)
    assert rl.collective_s == pytest.approx(1e10 / 50e9)
    assert rl.bound == "compute"
    assert 0 < rl.roofline_fraction <= 1.0
    ref = jsim.roofline(hlo, ref_config("tinyllama_1_1b"),
                        {s.name: s for s in REF_SHAPES}["train_4k"], 256)
    assert rl.to_dict() == ref.to_dict()


def test_wire_bytes_zero_key_not_overridden():
    zero_wire = dict(HLO, wire_bytes=0.0)
    no_key = {k: v for k, v in HLO.items() if k != "wire_bytes"}
    for hlo in (zero_wire, no_key):
        got = tsim.roofline(hlo, None, None, 1, host_s=jhw.HOST_OVERHEAD_S,
                            config=v5e())
        assert got.to_dict() == jsim.roofline(hlo, None, None, 1).to_dict()
    assert tsim.roofline(zero_wire, None, None, 1,
                         config=v5e()).collective_s == 0.0


def test_engine_roofline_matches_closed_form():
    rl = tsim.roofline(HLO, None, None, 256, host_s=jhw.HOST_OVERHEAD_S,
                       config=v5e())
    assert rl.compute_s == pytest.approx(HLO["flops"] / jhw.PEAK_FLOPS)
    assert rl.memory_s == pytest.approx(HLO["bytes"] / jhw.HBM_BW)
    assert rl.collective_s == pytest.approx(HLO["wire_bytes"] / jhw.ICI_BW)
    assert rl.to_dict() == jsim.roofline(HLO, None, None, 256).to_dict()


def test_engine_breakdown_matches_closed_form(v5e_host):
    b = tsim.breakdown(HLO, host_prep_s=100e-6, config=v5e())
    assert dataclasses.astuple(b) == dataclasses.astuple(
        jsim.breakdown(HLO, host_prep_s=100e-6))
    assert b.host_s == pytest.approx(100e-6 + jhw.HOST_OVERHEAD_S)


def test_energy_matches():
    assert tsim.energy(HLO, 0.25, 256) == jsim.energy(HLO, 0.25, 256)


def test_defaults_are_one_h100_at_its_bf16_peak():
    rl = tsim.roofline(HLO, None, None, 1)
    assert rl.compute_s == pytest.approx(HLO["flops"] / thw.PEAK_FLOPS_BF16)
    assert rl.memory_s == pytest.approx(HLO["bytes"] / thw.HBM_BW)
    assert tsim.breakdown(HLO).host_s == pytest.approx(thw.HOST_OVERHEAD_S)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops(arch):
    ref_shapes = {s.name: s for s in REF_SHAPES}
    for shape in SHAPES:
        assert tsim.model_flops(get_config(arch), shape) \
            == jsim.model_flops(ref_config(arch), ref_shapes[shape.name])


@pytest.mark.parametrize("n_ops", (1, 2, 8, 16))
@pytest.mark.parametrize("case", ("full", "zero_wire", "no_wire"))
def test_from_hlo_op_for_op(case, n_ops):
    hlo = {"full": HLO, "zero_wire": dict(HLO, wire_bytes=0.0),
           "no_wire": {k: v for k, v in HLO.items()
                       if k != "wire_bytes"}}[case]
    got, want = tir.from_hlo(hlo, n_ops=n_ops), jir.from_hlo(hlo, n_ops=n_ops)
    assert (got.name, got.source, got.meta) \
        == (want.name, want.source, want.meta)
    assert [tuple(getattr(op, f) for f in OP_FIELDS) for op in got.ops] \
        == [tuple(getattr(op, f) for f in OP_FIELDS) for op in want.ops]
    assert got.as_hlo_dict() == want.as_hlo_dict()
    t = got.totals()
    assert t["flops"] == pytest.approx(HLO["flops"], rel=1e-12)
    assert t["bytes_in"] + t["bytes_out"] == pytest.approx(HLO["bytes"],
                                                           rel=1e-12)


CONFIGS = [dict(n_workers=1, interface="dma"),
           dict(n_workers=4, interface="acp", hbm_ports=2),
           dict(n_workers=8, interface="hbm", hbm_ports=4,
                host_dispatch_s=1e-6)]


@pytest.mark.parametrize("executor", ["serial", "thread"])
def test_sweep_of_from_hlo_matches(executor):
    prog = tir.from_hlo(HLO, n_ops=16)
    got = sweep(prog, [tengine.EngineConfig(**V5E, **c) for c in CONFIGS],
                executor=executor)
    ref_prog = jir.from_hlo(HLO, n_ops=16)
    for res, c in zip(got, CONFIGS):
        want = jengine.run(ref_prog, jengine.EngineConfig(**c))
        assert res.makespan == want.makespan
        assert dataclasses.astuple(res.breakdown) \
            == dataclasses.astuple(want.breakdown)
        assert res.energy == want.energy


def test_lower_hlo_memoizes_on_content():
    clear_caches()
    p1 = lower_hlo(HLO, n_ops=8)
    assert lower_hlo(dict(HLO), n_ops=8) is p1
    assert lower_hlo(HLO, n_ops=4) is not p1
    assert lower_hlo(dict(HLO, flops=2e15), n_ops=8) is not p1
    ops = [tuple(getattr(op, f) for f in OP_FIELDS) for op in p1.ops]
    assert ops == [tuple(getattr(op, f) for f in OP_FIELDS)
                   for op in jir.from_hlo(HLO, n_ops=8).ops]


def test_lower_hlo_cache_is_true_lru(monkeypatch):
    sweep_mod = importlib.import_module("repro_torch.sim.sweep")
    clear_caches()
    monkeypatch.setattr(sweep_mod, "_CACHE_MAX", 2)
    hot = lower_hlo(HLO, n_ops=2)
    cold = lower_hlo(HLO, n_ops=3)
    assert lower_hlo(HLO, n_ops=2) is hot
    lower_hlo(HLO, n_ops=4)
    assert lower_hlo(HLO, n_ops=2) is hot
    assert lower_hlo(HLO, n_ops=3) is not cold
    clear_caches()
