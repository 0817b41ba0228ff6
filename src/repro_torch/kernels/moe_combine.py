"""The dropless MoE's combine on Hopper: the wrapper of
``csrc/moe_combine.cu``.

One kernel in place of ``models/moe.py::_combine``'s plain chain, which
replaces no TPU kernel (the JAX package has no dropless path):
``moe_combine(y, w, inv)`` sums each token's k expert rows of ``y``, found
at ``inv``, each times its gate in ``w``, in float32 in routing order, and
rounds once to bf16.

The wrapper checks its inputs, allocates the output, launches on
PyTorch's current stream and raises if the launch fails.  It takes CUDA
tensors only, y bf16, w float32 and inv int32, all contiguous, and checks
type and shape before the device, so that a CPU tensor of the wrong type
or shape is refused for that.  The plain version is
``repro_torch.kernels.ref.moe_combine_ref``, and
``repro_torch.kernels.ops.moe_combine`` picks between the two by device.
It has no backward: the dropless path serves only, and the wrapper raises
when autograd is recording and an input requires grad
(``_build.refuse_grad``).

``moe_combine.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

K_MAX = 8   # the most assignments a token (csrc: K_MAX)
_VEC = 8    # bf16 channels a thread reads as one 16-byte vector


@functools.cache
def _lib():
    lib = _build.load("moe_combine")
    lib.moe_combine_fwd.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.moe_combine_fwd.restype = ctypes.c_int
    return lib


def moe_combine(y, w, inv):
    """y: (T k, d) bf16, the experts' output rows in the dispatch's sorted
    order; w: (T, k) float32, each token's gates in routing order; inv:
    (T, k) int32, the row of y of each assignment (the inverse of the
    sort); all contiguous on one CUDA device, 1 <= k <= ``K_MAX``.  Returns
    (T, d) bf16: out[t] = sum_j w[t, j] * float(y[inv[t, j]]), summed in
    float32 over j in order and rounded once."""
    _build.refuse_grad("moe_combine", y, w)
    if y.dtype != torch.bfloat16 or w.dtype != torch.float32 \
            or inv.dtype != torch.int32:
        raise TypeError("moe_combine kernel takes y bfloat16, w float32 and "
                        f"inv int32, got {y.dtype}, {w.dtype}, {inv.dtype}")
    if y.dim() != 2 or w.dim() != 2 or inv.shape != w.shape \
            or y.shape[0] != w.numel() or 0 in y.shape:
        raise ValueError("moe_combine takes y (T k, d), w (T, k) and inv "
                         f"(T, k), got {[tuple(t.shape) for t in (y, w, inv)]}")
    T, k = w.shape
    if not 1 <= k <= K_MAX:
        raise ValueError(f"moe_combine kernel takes k of 1 to {K_MAX} "
                         f"assignments a token, got {k}")
    if not all(t.is_contiguous() for t in (y, w, inv)):
        raise ValueError("moe_combine kernel takes contiguous y, w and inv, "
                         f"got strides {[t.stride() for t in (y, w, inv)]}")
    _build.on_card("moe_combine", y, w, inv)
    d = y.shape[1]
    out = torch.empty(T, d, dtype=torch.bfloat16, device=y.device)
    vec = _VEC if d % _VEC == 0 and _build.aligned(y) \
        and _build.aligned(out) else 1
    with torch.cuda.device(y.device):
        rc = _lib().moe_combine_fwd(
            y.data_ptr(), w.data_ptr(), inv.data_ptr(), out.data_ptr(), T, k,
            d, vec, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"moe_combine kernel launch failed: cudaError_t "
                           f"{rc} (y {tuple(y.shape)}, k {k}, vec {vec})")
    moe_combine.launches += 1
    return out


moe_combine.launches = 0
