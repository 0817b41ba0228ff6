"""Mamba1 selective scan on Hopper: the wrapper of ``csrc/mamba_scan.cu``.

The CUDA kernel replaces the Pallas TPU kernel ``repro/kernels/mamba_scan.py``
(``_scan_kernel``).  It takes any S and d, and its block shapes from the
caller as the Pallas kernel does: ``bd`` channels a block (4 lanes each, so
4 bd threads) and ``chunk`` timesteps staged in shared memory at a time,
each 16, 32 or 64 (``tiles()``), 0, 0 for the default (32, 32).  Any other
pair raises ``ValueError`` (``tile_of``), here and in ``ops.mamba_scan`` on
the CPU alike, and the library refuses it too: no tile stands in for
another.  Unlike the reference, which takes any bd and chunk that divide d
and S, the kernel takes the named tile for any d and S and masks the
ragged edge.  Beyond the Pallas kernel
it takes a starting state ``h0`` and returns the final state on request,
as the model's ``mamba1_forward`` needs.  This wrapper checks its inputs,
makes them contiguous, allocates the outputs, launches on PyTorch's current
stream and raises if the launch fails.  It takes CUDA tensors only;
the plain version is ``repro_torch.kernels.ref.mamba_scan_ref`` and
``repro_torch.kernels.ops`` picks between the two by device.

The wrapper raises when autograd is recording and an input requires grad
(``_build.refuse_grad``): ``repro_torch.kernels.ops.mamba_scan`` is the
differentiable entry point.

``mamba_scan.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

STATE_DIMS = (8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_BD = (16, 32, 64)      # channels a block
TILE_CHUNK = (16, 32, 64)   # timesteps staged a chunk
DEFAULT_TILE = (32, 32)


def tiles():
    """The (bd, chunk) tiles the kernel instantiates, the default first."""
    return [DEFAULT_TILE, *((bd, c) for bd in TILE_BD for c in TILE_CHUNK
                            if (bd, c) != DEFAULT_TILE)]


def tile_of(bd=0, chunk=0):
    """The (bd, chunk) a call takes: the default where both are 0, else
    that tile.  Raises ``ValueError`` for a pair not in ``tiles()``, one
    value without the other too."""
    tile = (bd, chunk) if bd or chunk else DEFAULT_TILE
    if tile not in tiles():
        raise ValueError(f"mamba_scan has no tile (bd, chunk) = "
                         f"{(bd, chunk)}; tiles() = {tiles()}")
    return tile


@functools.cache
def _lib():
    lib = _build.load("mamba_scan")
    lib.mamba_scan_fwd.argtypes = [ctypes.c_void_p] * 9 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.mamba_scan_fwd.restype = ctypes.c_int
    lib.mamba_scan_tile.argtypes = [ctypes.c_int] * 4 \
        + [ctypes.POINTER(ctypes.c_int)]
    lib.mamba_scan_tile.restype = ctypes.c_int
    return lib


def instance(dtype, N, bd=0, chunk=0):
    """What the library reports of its instance for ``dtype``, state dim
    ``N`` and tile (bd, chunk) (0, 0: the default), on the card: a dict of
    its ``threads`` a block, ``smem_bytes``, ``regs`` a thread and
    ``local_bytes`` a thread (spills), or None where the library has no
    such instance."""
    out = (ctypes.c_int * 4)()
    if _lib().mamba_scan_tile(_DTYPES[dtype], N, bd, chunk, out):
        return None
    return dict(zip(("threads", "smem_bytes", "regs", "local_bytes"), out))


def check_state(h0, x, N):
    """Raises unless ``h0`` is a (b, d, N) float32 state on x's device; the
    plain version makes the same check."""
    bsz, _, d = x.shape
    if h0.shape != (bsz, d, N) or h0.dtype != torch.float32 \
            or h0.device != x.device:
        raise ValueError(f"h0 must be ({bsz}, {d}, {N}) float32 on "
                         f"{x.device}, got {tuple(h0.shape)} {h0.dtype} on "
                         f"{h0.device}")


def mamba_scan(x, dt, B, C, A, D, h0=None, return_state=False, bd=0,
               chunk=0):
    """x, dt: (b, S, d); B, C: (b, S, N), all float32 or all bfloat16;
    A: (d, N) float32; D: (d,) float32; N in ``STATE_DIMS``; all on one CUDA
    device.  ``h0``: the starting state, (b, d, N) float32, zeros if None.
    ``bd``, ``chunk``: the block's tile, one of ``tiles()``, or 0, 0 for the
    default.  Returns y: (b, S, d) in x's dtype, and with ``return_state``
    the pair (y, h_S), h_S the final state (b, d, N) float32."""
    ts = (x, dt, B, C, A, D)
    _build.refuse_grad("mamba_scan", *ts, h0)
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError("mamba_scan kernel takes x, dt, B, C, A, D on one "
                         f"CUDA device, got {[str(t.device) for t in ts]}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, B, C)) \
            or A.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError("mamba_scan kernel takes x, dt, B, C float32 or "
                        "bfloat16 of one type and A, D float32, got "
                        f"{[t.dtype for t in ts]}")
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty (b, S, d), got "
                         f"{tuple(x.shape)}")
    bsz, S, d = x.shape
    N = B.shape[-1] if B.dim() == 3 else -1
    if dt.shape != x.shape or B.shape != (bsz, S, N) or C.shape != B.shape \
            or A.shape != (d, N) or D.shape != (d,):
        raise ValueError("mamba_scan takes x, dt (b, S, d), B, C (b, S, N), "
                         "A (d, N), D (d,), got "
                         f"{[tuple(t.shape) for t in ts]}")
    if N not in STATE_DIMS:
        raise ValueError(f"state dim N={N} not in {STATE_DIMS}")
    bd, chunk = tile_of(bd, chunk)
    if h0 is not None:
        check_state(h0, x, N)
        h0 = h0.contiguous()
    x, dt, B, C, A, D = (t.contiguous() for t in ts)
    y = torch.empty_like(x)
    hT = torch.empty(bsz, d, N, dtype=torch.float32, device=x.device) \
        if return_state else None
    with torch.cuda.device(x.device):
        rc = _lib().mamba_scan_fwd(
            x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), D.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), None if hT is None else hT.data_ptr(), bsz, S, d, N,
            _DTYPES[x.dtype], bd, chunk,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"mamba_scan kernel launch failed: cudaError_t "
                           f"{rc} (tile {(bd, chunk)})")
    mamba_scan.launches += 1
    return (y, hT) if return_state else y


mamba_scan.launches = 0
