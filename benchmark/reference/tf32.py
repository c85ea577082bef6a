"""TF32 in plain float32 arithmetic: the control's precision.

A TF32 product rounds both operands to a 10-bit mantissa (round to nearest,
ties to even) and sums in float32. :func:`operand` does that rounding to
what it is given; :func:`grad` leaves a tensor as it is and rounds the
gradient that reaches it, so that a backward conv sees rounded operands
too. The same bits on the CPU and on the card."""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.float().contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & ~0x1FFF
    return i.view(torch.float32)


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def operand(x: torch.Tensor) -> torch.Tensor:
    return _Operand.apply(x) if torch.is_grad_enabled() and x.requires_grad else round_tf32(x)


def grad(x: torch.Tensor) -> torch.Tensor:
    return _Grad.apply(x) if torch.is_grad_enabled() and x.requires_grad else x
