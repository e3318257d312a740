"""Arithmetic precision of the reference: float64, or the rounding of a
lower precision applied to the operands of every matmul and convolution
(the control that a correct run must tell apart from the program).

``"float64"`` is the reference's own: at 768² cuDNN's float32 convolutions
(TF32 off) sit 4e-5 to 4e-4 from float64 in the loss, further than the
port's float32 route (3xTF32) does. ``"tf32"`` rounds each product's operands to TF32 (10 mantissa
bits, nearest even), forward and backward, as the tensor cores do with TF32
on: the control of a float32 configuration. ``"fp8"`` rounds forward
operands to float8 e4m3 and gradients to e5m2, each tensor scaled by its
largest magnitude onto the format's range, the usual fp8 training recipe:
the control of a bfloat16 configuration. The rounded formats accumulate in
float32 with TF32 off (``full_float32``).
"""

from __future__ import annotations

import contextlib

import torch

_E4M3_MAX, _E5M2_MAX = 448.0, 57344.0
ROUNDED = ("tf32", "fp8")


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    bits = t.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _round_fp8(t: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / fmax
    return (t / scale).to(dtype).float() * scale


def round_fwd(t: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "tf32":
        return round_tf32(t)
    return _round_fp8(t, torch.float8_e4m3fn, _E4M3_MAX)


def round_bwd(t: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "tf32":
        return round_tf32(t)
    return _round_fp8(t, torch.float8_e5m2, _E5M2_MAX)


class _Operand(torch.autograd.Function):
    """Forward: the operand rounded; backward: the gradient as it comes."""

    @staticmethod
    def forward(ctx, t, fmt):
        return round_fwd(t, fmt)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradOperand(torch.autograd.Function):
    """Forward: identity; backward: the incoming gradient rounded, as the
    operand of the products that propagate it."""

    @staticmethod
    def forward(ctx, t, fmt):
        ctx.fmt = fmt
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return round_bwd(g, ctx.fmt), None


def operand(t: torch.Tensor, fmt: str) -> torch.Tensor:
    return _Operand.apply(t, fmt) if fmt in ROUNDED else t


def grad_operand(t: torch.Tensor, fmt: str) -> torch.Tensor:
    return _GradOperand.apply(t, fmt) if fmt in ROUNDED else t


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
