"""The port's matmul tiling chooser held against the JAX package's.

``repro_torch.core.tiling.choose_matmul_tiling`` at :data:`V5E` (the
reference's TPU v5e constants) is the reference's
``repro.core.tiling.choose_matmul_tiling``, field for field, on
``tests/test_tiling.py``'s hypothesis grid, on every conv and FC product of
the Table-III nets (the graph path at batch 1 and 64), on the calibration's
``model`` grid and the quickstart's convs, in float32 and bf16.  At
:data:`H100` every choice is one of the tiles the CUDA kernel instantiates
(``nvdla_matmul.tiles``), fits 227 KB of shared memory with its stages,
keeps the wgmma variants' tiles on 64 rows and 8 columns, and splits K only
where the output tiles fill less than one wave of the 132 SMs.
"""
import dataclasses
import itertools
import math

import pytest
import torch

from repro.core import tiling as jtiling
from repro_torch.apps.paper_graphs import build_paper_graph
from repro_torch.configs.paper_nets import PAPER_NETS
from repro_torch.core import graph_ops, tiling
from repro_torch.kernels import calibrate
from repro_torch.kernels import nvdla_matmul as mm

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tests/test_tiling.py:63-73's hypothesis grid, whole
HYP_GRID = list(itertools.product([128, 384, 1024, 4096], [128, 256, 2048],
                                  [128, 512, 5632]))
MODEL_GRID = list(calibrate.MODEL_GRIDS["matmul"])
QUICKSTART = [(1024, 64, 72), (1024, 8, 576)]
# the kernel's SMEM of a TMA ring tile (csrc/nvdla_matmul.cu: 1024 bytes of
# alignment slack, the stages, bf16's staged output, 16 barrier bytes a
# stage), and 227 KB, the H100's dynamic shared memory a block
SMEM_LIMIT = 232448


def _products(net, batch):
    g = build_paper_graph(PAPER_NETS[net], batch)
    return [graph_ops.product_shape(g, g.nodes[k]) for k in g.order
            if g.nodes[k].op in ("convolution", "matmul")]


def _astuple(t):
    """The reference's seven fields."""
    return dataclasses.astuple(t)[:7]


def test_v5e_target_holds_the_reference_constants():
    assert tiling.V5E.matmul_budget == jtiling.VMEM_BYTES // 2
    assert tiling.V5E.reduce_quantum == jtiling.MXU_DIM
    assert tiling.V5E.hbm_bw == jtiling.HBM_BW
    assert tiling.V5E.copy_latency_s == jtiling.HBM_LATENCY_US * 1e-6
    assert tiling.V5E.sm_count == 1
    # the reference's candidate blocks, whole
    assert len(tiling.V5E_BLOCKS) == 45 and {
        b[2] for b in tiling.V5E_BLOCKS} == {128, 256, 512, 1024, 2048}


@pytest.mark.parametrize("dtype", list(DTYPE_BYTES))
def test_v5e_equals_reference_on_the_hypothesis_grid(dtype):
    db = DTYPE_BYTES[dtype]
    for m, n, k in HYP_GRID:
        t = tiling.choose_matmul_tiling(m, n, k, db, target=tiling.V5E)
        assert _astuple(t) == dataclasses.astuple(
            jtiling.choose_matmul_tiling(m, n, k, db)), (m, n, k)
        assert (t.stages, t.splits, t.variant) == (1, 1, "")


@pytest.mark.parametrize("dtype", list(DTYPE_BYTES))
@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("net", list(PAPER_NETS))
def test_v5e_equals_reference_on_the_graph_path(net, batch, dtype):
    db = DTYPE_BYTES[dtype]
    for m, n, k in _products(net, batch):
        assert _astuple(tiling.choose_matmul_tiling(
            m, n, k, db, target=tiling.V5E)) == dataclasses.astuple(
                jtiling.choose_matmul_tiling(m, n, k, db)), (m, n, k)


@pytest.mark.parametrize("dtype", list(DTYPE_BYTES))
def test_v5e_equals_reference_on_model_grid_and_quickstart(dtype):
    db = DTYPE_BYTES[dtype]
    for m, n, k in MODEL_GRID + QUICKSTART + [(17, 3, 1), (1, 1, 1)]:
        assert _astuple(tiling.choose_matmul_tiling(
            m, n, k, db, target=tiling.V5E)) == dataclasses.astuple(
                jtiling.choose_matmul_tiling(m, n, k, db)), (m, n, k)


@pytest.mark.parametrize("budget", [0, 1 << 16, 1 << 20, 1 << 24])
def test_v5e_budget_is_the_reference_vmem_budget(budget):
    """A budget passed explicitly, down to none fitting (the reference's
    fallback blocks)."""
    for m, n, k in [(4096, 2048, 5632), (384, 256, 512), (64, 10, 512)]:
        assert _astuple(tiling.choose_matmul_tiling(
            m, n, k, 2, budget, target=tiling.V5E)) == dataclasses.astuple(
                jtiling.choose_matmul_tiling(m, n, k, 2, budget))


def _h100_shapes():
    shapes = set(MODEL_GRID + QUICKSTART + HYP_GRID)
    for net in PAPER_NETS:
        for batch in (1, 64):
            shapes.update(_products(net, batch))
    shapes.update([(17, 130, 33), (100, 72, 200), (40, 24, 1), (1, 3, 1),
                   (4, 1152, 6912), (4100, 1032, 1152), (200, 6912, 1152)])
    return sorted(shapes)


def _check_h100(t, m, n, k, dtype):
    assert t.variant == mm.variant(m, n, k, dtype)
    assert (t.bm, t.bn, t.bk) in mm.tiles(t.variant)
    kern = tiling.matmul_kernel(t.variant)
    assert (t.bm, t.bn, t.bk, t.stages, t.vmem_bytes) in kern.tiles
    assert t.vmem_bytes <= SMEM_LIMIT
    if t.variant == "tf32x3":   # hi and lo of both operands, every stage
        assert t.vmem_bytes == 1024 + t.stages * (
            2 * (t.bm + t.bn) * 32 * 4 + 16)
    if t.variant == "wgmma":    # and the bf16 output staged for TMA
        assert t.vmem_bytes == 1024 + t.stages * (
            (t.bm + t.bn) * 64 * 2 + 16) + t.bm * t.bn * 2
    if kern.ring:   # wgmma's 64 rows, N a multiple of 8
        assert t.bm % 64 == 0 and t.bn % 8 == 0
        assert t.bk * dtype.itemsize == 128     # one 128-byte TMA row
    tiles = math.ceil(m / t.bm) * math.ceil(n / t.bn)
    if t.splits > 1:
        assert tiles < tiling.H100.sm_count and kern.split_depth
        assert tiling.aligned_splits(k, t.splits, kern.split_align) \
            == t.splits
        if kern.persistent:     # the split fills at most one wave
            assert tiles * t.splits <= tiling.H100.sm_count
    for u in (t.util_m, t.util_n, t.util_k):
        assert 0 < u <= 1


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_h100_choices_are_instantiated_tiles_that_fit(dtype):
    for m, n, k in _h100_shapes():
        t = tiling.choose_matmul_tiling(m, n, k, DTYPES[dtype].itemsize)
        _check_h100(t, m, n, k, DTYPES[dtype])


@pytest.mark.parametrize("name", list(mm.VARIANTS))
def test_h100_every_variant_chooses_among_its_own_tiles(name):
    dtype = mm.VARIANTS[name][1]
    for m, n, k in _h100_shapes():
        if not mm._takes(name, m, n, k, dtype):
            continue
        t = tiling.choose_matmul_tiling(m, n, k, dtype.itemsize,
                                        variant=name)
        assert t.variant == name and (t.bm, t.bn, t.bk) in mm.tiles(name)
        assert t.vmem_bytes <= SMEM_LIMIT


def test_h100_splits_k_only_below_one_wave():
    """The graph path's (64, 128, 6272) is one 128 x 128 tile: K splits;
    the model grid's tiles fill many waves: it does not."""
    t = tiling.choose_matmul_tiling(64, 128, 6272, 4)
    assert t.variant == "tf32x3" and t.splits > 1
    for m, n, k in MODEL_GRID:
        t = tiling.choose_matmul_tiling(m, n, k, 4)
        if t.variant == "tf32x3":
            assert t.splits == 1
    for dtype in (torch.float32, torch.bfloat16):
        for m, n, k in _h100_shapes():
            t = tiling.choose_matmul_tiling(m, n, k, dtype.itemsize)
            if math.ceil(m / t.bm) * math.ceil(n / t.bn) >= 132:
                assert t.splits == 1, (m, n, k, t)


def _stream_split_k(N, K):
    """The split csrc/nvdla_matmul.cu's stream kernel chose by itself
    (its stream_split_k) before the chooser took the decision."""
    blocks_n = -(-N // 1024)
    if blocks_n >= 132:
        return 1
    splits = max(1, min(-(-4 * 132 // blocks_n), K // 64))
    per = -(-K // splits)
    chunk = -(-per // 8) * 8
    return -(-K // chunk)


def test_stream_split_is_the_kernel_rule_it_replaces():
    """The decoding-row kernel's split moved from the CUDA host code to the
    chooser unchanged."""
    for m, n, k in _h100_shapes():
        if m <= 16:
            t = tiling.choose_matmul_tiling(m, n, k, 4)
            assert t.variant == "stream"
            assert t.splits == _stream_split_k(n, k), (m, n, k)


def test_h100_budget_cuts_tiles_and_raises_when_none_fits():
    small = tiling.choose_matmul_tiling(4096, 6912, 1152, 4, 150_000)
    assert small.vmem_bytes <= 150_000
    with pytest.raises(ValueError, match="fits"):
        tiling.choose_matmul_tiling(4096, 6912, 1152, 4, 1000)


@pytest.mark.parametrize("K,align", [(6272, 32), (1000, 32), (100, 32),
                                     (6912, 8), (33, 8), (1, 32)])
def test_aligned_splits_are_a_fixed_point(K, align):
    """A count ``aligned_splits`` gives leaves each of its k ranges
    non-empty, and gives itself back: the kernel's ``split_chunk`` accepts
    exactly these."""
    for s in range(1, 200):
        a = tiling.aligned_splits(K, s, align)
        chunk = -(-(-(-K // a)) // align) * align
        assert 1 <= a <= s and -(-K // chunk) == a
        assert tiling.aligned_splits(K, a, align) == a


def test_chooser_is_deterministic():
    shapes = _h100_shapes()
    first = [tiling.choose_matmul_tiling(m, n, k, 4) for m, n, k in shapes]
    tiling._choose_hopper.cache_clear()
    again = [tiling.choose_matmul_tiling(m, n, k, 4) for m, n, k in shapes]
    assert first == again
    copy = dataclasses.replace(tiling.H100)
    assert copy == tiling.H100 and hash(copy) == hash(tiling.H100)
    assert [tiling.choose_matmul_tiling(m, n, k, 4, target=copy)
            for m, n, k in shapes] == first


def test_chooser_takes_a_block_and_its_own_split():
    t = tiling.choose_matmul_tiling(64, 128, 6272, 4, block=(128, 128, 32))
    assert (t.bm, t.bn, t.bk, t.stages) == (128, 128, 32, 3)
    assert t.splits == tiling.split_count(
        64, 128, 6272, (128, 128), tiling.matmul_kernel("tf32x3"), 132)
    with pytest.raises(ValueError):
        tiling.choose_matmul_tiling(64, 128, 6272, 4, block=(128, 128, 64))


def test_unknown_dtype_has_no_variant():
    with pytest.raises(ValueError):
        tiling.hopper_variant(128, 128, 128, 1)
    with pytest.raises(ValueError):
        tiling.matmul_kernel("nope")
