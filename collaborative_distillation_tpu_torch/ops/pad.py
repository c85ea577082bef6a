"""Reflect padding of NHWC maps by index math, plain PyTorch on any device."""

from __future__ import annotations

import torch

__all__ = ["reflect_index", "reflect_pad"]


def reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source indices of an ``n``-long axis reflect-padded by (before, after),
    as ``np.pad(mode="reflect")`` pads it, pads longer than the axis included.

    A length-1 axis reflects onto itself (``jnp.pad`` gives ``[v, v, v]``),
    where ``F.pad(mode="reflect")`` raises.
    """
    i = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = i.remainder(period)
    return torch.where(m < n, m, period - m)


def reflect_pad(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Reflection-pad H and W of an NHWC tensor by ``pad`` on every side."""
    if pad == 0:
        return x
    _, h, w, _ = x.shape
    x = x.index_select(1, reflect_index(h, pad, pad, x.device))
    return x.index_select(2, reflect_index(w, pad, pad, x.device))
