"""The port's trace reader (``repro_torch.core.hlo``) against the JAX
package's ``repro.core.hlo``, on the CPU.

``analyze_hlo`` is a copy: on the compiled HLO text of
``tests/test_hlo.py``'s four jitted functions (made here) it returns the
reference's dict, ``==``.  ``analyze_step`` traces the torch counterparts
of those functions on fake tensors, and holds ``tests/test_hlo.py``'s own
bounds against the reference's numbers: ``dot_flops`` within 5% of the
reference's, at least 2 x 1024 transcendentals, bytes of a copy in
[n, 4n].  Collectives over a fake process group of known sizes give
``collective_bytes`` and ``wire_bytes`` by the reference's ring model, and
the kernels' calls land in ``custom_calls`` priced by
``kernels.calibrate``'s accounting.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.hlo import analyze_hlo as ref_analyze_hlo
from repro_torch.core.hlo import analyze_hlo, analyze_step
from repro_torch.kernels import calibrate, ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan(x, w):
    def body(c, wi):
        return jnp.tanh(c @ wi), ()
    return jax.lax.scan(body, x, w)[0]


def _nested(x, w):
    def outer(c, wi):
        def inner(c2, _):
            return jnp.tanh(c2 @ wi), ()
        return jax.lax.scan(inner, c, None, length=4)[0], ()
    return jax.lax.scan(outer, x, w)[0]


def _elementwise(x):
    return jnp.sum(jnp.exp(x) * x + jnp.tanh(x))


def _copy(x):
    return x * 2.0


SDS = jax.ShapeDtypeStruct
CASES = {
    "scan": (_scan, (SDS((64, 128), jnp.float32),
                     SDS((10, 128, 128), jnp.float32))),
    "nested": (_nested, (SDS((32, 64), jnp.float32),
                         SDS((3, 64, 64), jnp.float32))),
    "elementwise": (_elementwise, (SDS((1024,), jnp.float32),)),
    "copy": (_copy, (SDS((1 << 20,), jnp.float32),)),
}


def _text(name):
    fn, args = CASES[name]
    return jax.jit(fn).lower(*args).compile().as_text()


@pytest.mark.parametrize("name", tuple(CASES))
def test_analyze_hlo_is_the_reference(name):
    text = _text(name)
    assert analyze_hlo(text) == ref_analyze_hlo(text)


def _torch_scan(x, w):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


def _torch_nested(x, w):
    for i in range(w.shape[0]):
        for _ in range(4):
            x = torch.tanh(x @ w[i])
    return x


def test_analyze_step_dot_flops_within_5pct_of_the_reference():
    for name, fn, args in (
            ("scan", _torch_scan, (torch.randn(64, 128),
                                   torch.randn(10, 128, 128))),
            ("nested", _torch_nested, (torch.randn(32, 64),
                                       torch.randn(3, 64, 64)))):
        want = ref_analyze_hlo(_text(name))["dot_flops"]
        got = analyze_step(fn, *args)
        assert abs(got["dot_flops"] - want) / want < 0.05, (name, got, want)
        assert got["n_while"] == 0


def test_analyze_step_elementwise_and_transcendentals():
    res = analyze_step(lambda x: torch.sum(torch.exp(x) * x + torch.tanh(x)),
                       torch.randn(1024))
    assert res["transcendentals"] >= 2 * 1024
    assert res["flops"] >= 3 * 1024
    ref = ref_analyze_hlo(_text("elementwise"))
    assert res["transcendentals"] >= ref["transcendentals"]


def test_analyze_step_bytes_of_a_copy():
    res = analyze_step(lambda x: x * 2.0, torch.randn(1 << 20))
    nbytes = 4 * (1 << 20)
    assert nbytes <= res["bytes"] <= 4 * nbytes
    ref = ref_analyze_hlo(_text("copy"))
    assert nbytes <= ref["bytes"] <= 4 * nbytes
    mem = res["memory"]
    assert mem["argument_bytes"] == nbytes == mem["output_bytes"]
    assert mem["alias_bytes"] == 0 and mem["temp_bytes"] >= nbytes


def test_analyze_step_allocates_nothing():
    """A real input is replaced by a fake one: a 64 GiB product traces."""
    n = 1 << 17
    res = analyze_step(lambda a, b: a @ b, torch.empty(n, n, device="meta"),
                       torch.empty(n, n, device="meta"))
    assert res["dot_flops"] == 0     # meta tensors: shapes only, not counted
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a, b = torch.empty(n, n), torch.empty(n, n)
    res = analyze_step(lambda a, b: a @ b, a, b)
    assert res["dot_flops"] == 2.0 * n ** 3


def test_collectives_by_the_ring_model():
    """all_reduce / all_gather / reduce_scatter of known sizes over the
    ``model`` (4) and ``data`` (2) groups of a fake world of 8 ranks."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_host_mesh
    with fake_world(8):
        mesh = make_host_mesh(2, 4, device_type="cpu")
        model, data = mesh.get_group("model"), mesh.get_group("data")

        def step(x, y):
            dist.all_reduce(x, group=model)               # 4 KiB, n 4
            dist.all_reduce(y, group=data)                # 2 KiB, n 2
            out = x.new_empty(4 * x.shape[0], x.shape[1])
            dist.all_gather_into_tensor(out, x, group=model)
            rs = x.new_empty(x.shape[0] // 4, x.shape[1])
            dist.reduce_scatter_tensor(rs, x, group=model)
            return out, rs
        res = analyze_step(step, torch.zeros(64, 16),
                           torch.zeros(32, 16))
    xb, yb = 64 * 16 * 4, 32 * 16 * 4
    c = res["collectives"]
    assert c["all-reduce"] == {"count": 2, "bytes": xb + yb}
    assert c["all-gather"] == {"count": 1, "bytes": xb}
    assert c["reduce-scatter"] == {"count": 1, "bytes": xb}
    assert res["collective_bytes"] == 2 * xb + yb + xb
    wire = (2 * 0.75 * xb + 2 * 0.5 * yb     # all-reduce: 2 (n-1)/n
            + 0.75 * 4 * xb                  # all-gather: (n-1)/n output
            + 0.75 * xb)                     # reduce-scatter: (n-1)/n
    assert res["wire_bytes"] == pytest.approx(wire, rel=1e-12)


def test_kernels_priced_by_their_accounting():
    """Each kernel call lands in ``custom_calls``, priced by
    ``kernels.calibrate``'s accounting (bytes at the operands' element
    size), not by its plain version's arithmetic; the flash backward is
    the plain one, traced."""
    B, H, Hkv, S, D = 2, 4, 2, 64, 16
    q = torch.randn(B, H, S, D, dtype=torch.bfloat16)
    k = torch.randn(B, Hkv, S, D, dtype=torch.bfloat16)
    res = analyze_step(lambda q, k: ops.flash_attention(q, k, k), q, k)
    f, b = calibrate.attention_cost(B, H, Hkv, S, D)
    assert res["custom_calls"] == {"flash_attention": 1}
    assert res["dot_flops"] == f and res["bytes"] == b / 2
    assert res["transcendentals"] == B * H * S * S / 2

    b_, L, d, N = 2, 32, 8, 4
    scan_in = [torch.randn(b_, L, d), torch.rand(b_, L, d),
               torch.randn(b_, L, N), torch.randn(b_, L, N),
               -torch.rand(d, N), torch.randn(d)]
    res = analyze_step(lambda *a: ops.mamba_scan(*a), *scan_in)
    f, b = calibrate.mamba_cost(b_, L, d, N)
    assert res["custom_calls"] == {"mamba_scan": 1}
    assert (res["flops"], res["bytes"], res["dot_flops"]) == (f, b, 0.0)

    res = analyze_step(lambda a, b: ops.matmul(a, b), torch.randn(48, 32),
                       torch.randn(32, 24))
    f, b = calibrate.matmul_cost(48, 24, 32)
    assert res["custom_calls"] == {"matmul": 1}
    assert (res["dot_flops"], res["bytes"]) == (f, b)

    q.requires_grad_(True)

    def fwd_bwd(q, k):
        out = ops.flash_attention(q, k, k)
        return torch.autograd.grad(out.float().sum(), q)
    res = analyze_step(fwd_bwd, q, k)
    assert res["custom_calls"] == {"flash_attention": 1}
    assert res["dot_flops"] > f      # the plain backward's products
    # the stand-ins are gone once the analyzer returns
    assert ops.flash_attention.__module__ == "repro_torch.kernels.ops"


def test_scan_backward_unsampled_from_three_lengths():
    """The scan's plain backward, traced at 1, 2 and 3 steps and unsampled
    to the call's length (a + b S + c S^2), equals the trace of the whole
    loop."""
    from repro_torch.core import hlo
    b_, L, d, N = 1, 24, 4, 3
    args = [torch.randn(b_, L, d), torch.rand(b_, L, d),
            torch.randn(b_, L, N), torch.randn(b_, L, N),
            -torch.rand(d, N), torch.randn(d)]
    from repro_torch.kernels import ref
    dy = torch.ones(b_, L, d)
    full = analyze_step(lambda *a: ref.mamba_scan_bwd_ref(
        *a[:6], None, a[6], None), *args, dy)
    counter = hlo._Counter()
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        hlo._sampled_scan_bwd(counter, *args, None, dy, None)
    for key in ("flops", "transcendentals", "bytes"):
        assert getattr(counter.cost, key) == pytest.approx(full[key],
                                                           rel=1e-9), key
