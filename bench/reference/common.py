"""What the references share: float32 products with TF32 off, or their
float8 control, and the RMS norm."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0   # the largest finite float8 e4m3fn


@contextlib.contextmanager
def exact_float32():
    """float32 products computed in float32 (TF32 off), restored after."""
    cuda = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def fp8(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for each slice along
    ``dim`` (its largest magnitude onto the format's largest), in
    float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """The references' products: ``mm(a, w)`` of a (..., K) and w (K, N);
    ``rows(t)`` and ``cols(t)`` round a tensor whose last, or second to
    last, dimension a product contracts."""

    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32, or fp8 (control)")
        self.name = name

    def rows(self, t):
        return fp8(t, -1) if self.name == "fp8" else t

    def cols(self, t):
        return fp8(t, -2) if self.name == "fp8" else t

    def mm(self, a, w):
        w = w.float()
        if self.name == "fp8":
            a, w = fp8(a, -1), fp8(w, 0)
        return a @ w


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()
