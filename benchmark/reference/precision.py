"""Precision of the reference's products.

"f32": operands and sums in float32 with TF32 off, the precision the
reference is defined in. "fp8": the control, the step below the bfloat16
the configurations state: each operand is scaled by its largest magnitude
onto float8 e4m3's range, rounded to e4m3 and scaled back, and the sums run
in float32, as a per-tensor scaled fp8 product does; in a backward the
gradient reaching a rounded operand is rounded to float8 e5m2 the same
way, as fp8 training rounds gradients.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _scaled(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _Float8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _scaled(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision must be 'f32' or 'fp8', got {name!r}")
        self.name = name

    def round(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as an f32 tensor carrying this precision's operand values."""
        t = t.float()
        return t if self.name == "f32" else _Float8.apply(t)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)

    def linear(self, x, weight, bias=None):
        return F.linear(self.round(x), self.round(weight), bias)

    def conv2d(self, x, weight, stride, padding):
        return F.conv2d(self.round(x), self.round(weight), None, stride, padding)


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and cuDNN convolutions inside the block; the
    settings before it are restored after."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)
