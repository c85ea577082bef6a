"""Core image-network ops, NHWC activations and HWIO weights, float32.

Each op that the reference ran through a Pallas kernel dispatches on the
device of its input: a CPU tensor takes the kernel's plain PyTorch version, a
CUDA tensor launches the hand-written kernel (``ops/cuda``), which raises on
what it does not take. Nothing falls back from the card to the plain path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda import conv as _kconv
from .cuda import pool as _kpool
from .pad import reflect_pad

__all__ = ["reflect_pad", "conv2d", "conv3x3", "conv1x1", "max_pool_2x2",
           "upsample_nearest_2x", "on_card"]


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """VALID conv, NHWC x HWIO -> NHWC, float32."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b)
    return y.permute(0, 2, 3, 1).contiguous()


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU one (plain version);
    any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {x.device}")


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
            relu: bool = True) -> torch.Tensor:
    """Reflect-pad(1) + 3x3 VALID conv (+ optional ReLU): the reference's
    universal conv block (model_original.py:494 ``relu(conv(pad(x)))``)."""
    if on_card(x):
        return _kconv.conv3x3_reflect(x, w, b, relu)
    return _kconv.conv3x3_plain(x, w, b, relu)


def conv1x1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
            relu: bool = False) -> torch.Tensor:
    """1x1 conv as one product over the pixels (``conv0`` and the aux
    adapters; the reference leaves these to XLA outside any Pallas kernel)."""
    y = x @ w.reshape(w.shape[-2], w.shape[-1])
    if b is not None:
        y = y + b
    return torch.relu(y) if relu else y


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool, floor semantics (nn.MaxPool2d(2, 2))."""
    if on_card(x):
        return _kpool.max_pool_2x2(x)
    return _kpool.max_pool_2x2_plain(x)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (nn.UpsamplingNearest2d(scale_factor=2))."""
    if on_card(x):
        return _kpool.upsample_nearest_2x(x)
    return _kpool.upsample_nearest_2x_plain(x)
