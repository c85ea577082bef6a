"""Core image-network ops, NHWC activations and HWIO weights, float32.

Each op that the reference ran through a Pallas kernel dispatches on the
device of its input: a CPU tensor takes the kernel's plain PyTorch version, a
CUDA tensor launches the hand-written kernel (``ops/cuda``), which raises on
what it does not take. Nothing falls back from the card to the plain path.

Where autograd is recording and an input requires grad, the op goes through
its ``torch.autograd.Function`` (``ops/cuda/autograd.py``), whose forward is
the same kernel or plain version and whose backward has JAX's subgradients;
otherwise it takes the launch as it is, so inference counts and computes
exactly what it did.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda import autograd as _grad
from .cuda import conv as _kconv
from .cuda import pool as _kpool
from .pad import reflect_pad

__all__ = ["reflect_pad", "conv2d", "conv3x3", "conv1x1", "max_pool_2x2",
           "max_pool_2x2_with_argmax", "max_unpool_2x2", "upsample_nearest_2x", "on_card"]


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


def _records_grad(*tensors) -> bool:
    """True where autograd records and one of ``tensors`` requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
            relu: bool = True) -> torch.Tensor:
    """Reflect-pad(1) + 3x3 VALID conv (+ optional ReLU): the reference's
    universal conv block (model_original.py:494 ``relu(conv(pad(x)))``)."""
    if _records_grad(x, w, b):
        fwd = _kconv.conv3x3_reflect if on_card(x) else _kconv.conv3x3_plain
        return _grad.Conv3x3.apply(x, w, b, relu, fwd)
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
    if not relu:
        return y
    return _grad.JaxRelu.apply(y) if _records_grad(y) else torch.relu(y)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool, floor semantics (nn.MaxPool2d(2, 2))."""
    if _records_grad(x):
        fwd = _kpool.max_pool_2x2 if on_card(x) else _kpool.max_pool_2x2_plain
        return _grad.MaxPool2x2.apply(x, fwd)
    if on_card(x):
        return _kpool.max_pool_2x2(x)
    return _kpool.max_pool_2x2_plain(x)


def max_pool_2x2_with_argmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """2x2/stride-2 max pool that also returns each window's argmax, int32
    ``dy * 2 + dx`` (ties to the first maximum, as ``jnp.argmax``); an odd
    last row or column is dropped. The photo-WCT encoder's pool
    (model_cd.py:443-449). The reference leaves it to XLA, not a Pallas
    kernel: plain torch on both devices, its maxima the ``max_pool_2x2``
    kernel's bit for bit (a maximum is exact)."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    win = (x[:, :2 * h2, :2 * w2].reshape(n, h2, 2, w2, 2, c)
           .permute(0, 1, 3, 2, 4, 5).reshape(n, h2, w2, 4, c))
    return win.amax(dim=3), win.argmax(dim=3).to(torch.int32)


def max_unpool_2x2(x: torch.Tensor, idx: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Inverse of :func:`max_pool_2x2_with_argmax`: each pooled value back
    at its argmax position, zeros elsewhere (torch ``MaxUnpool2d(2, 2)``),
    zero-padded to ``out_hw``. A one-hot product, as the reference's."""
    n, h2, w2, c = x.shape
    onehot = idx.unsqueeze(3) == torch.arange(4, device=idx.device).view(4, 1)
    y = (onehot.to(x.dtype) * x.unsqueeze(3)).reshape(n, h2, w2, 2, 2, c)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h2, 2 * w2, c)
    oh, ow = out_hw
    if (oh, ow) != (2 * h2, 2 * w2):
        y = F.pad(y, (0, 0, 0, ow - 2 * w2, 0, oh - 2 * h2))
    return y


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (nn.UpsamplingNearest2d(scale_factor=2))."""
    if _records_grad(x):
        fwd = _kpool.upsample_nearest_2x if on_card(x) else _kpool.upsample_nearest_2x_plain
        return _grad.UpsampleNearest2x.apply(x, fwd)
    if on_card(x):
        return _kpool.upsample_nearest_2x(x)
    return _kpool.upsample_nearest_2x_plain(x)
