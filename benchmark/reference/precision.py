"""The control's precision, in plain float32 arithmetic.

The control is the reference computed in the precision next below the one
the configuration states (:func:`control`): TF32 for float32 with TF32 off,
bfloat16 for float32 with TF32 on, fp8 (e4m3) for bfloat16 or float16. A
product in it rounds both operands to that precision and sums in float32.
:func:`operand` does that rounding to what it is given; :func:`grad` leaves
a tensor as it is and rounds the gradient that reaches it, so that a
backward conv sees rounded operands too. TF32 and bfloat16 round to nearest,
ties to even; fp8 scales the tensor so that its largest magnitude is e4m3's
largest, 448, rounds and scales back (one scale a tensor, as fp8 GEMMs
take it). The same bits on the CPU and on the card."""

from __future__ import annotations

import torch

# the precisions a configuration may state, and float32's TF32 flag
DTYPES = ("float32", "bfloat16", "float16")
_FP8_MAX = 448.0


def control(cfg: dict) -> str:
    """The control's precision for a configuration's ``dtype`` and ``tf32``."""
    dtype, tf32 = cfg["dtype"], cfg["tf32"]
    if dtype not in DTYPES or not isinstance(tf32, bool):
        raise ValueError(f"dtype {dtype!r} (one of {DTYPES}) and tf32 {tf32!r} (a bool)")
    if dtype == "float32":
        return "bfloat16" if tf32 else "tf32"
    return "fp8"


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.float().contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & ~0x1FFF
    return i.view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.float().to(torch.bfloat16).float()


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, _FP8_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


ROUND = {"tf32": round_tf32, "bfloat16": round_bf16, "fp8": round_fp8}


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision):
        return ROUND[precision](x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision):
        ctx.precision = precision
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ROUND[ctx.precision](g), None


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to ``precision``; as it is at the reference's own
    (any precision not in :data:`ROUND`)."""
    if precision not in ROUND:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Operand.apply(x, precision)
    return ROUND[precision](x)


def grad(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision in ROUND and torch.is_grad_enabled() and x.requires_grad:
        return _Grad.apply(x, precision)
    return x
