"""Per-pixel 1x1 conv: the ``conv1x1_bias`` kernel and its plain version.

The kernel (``csrc/conv1x1.cu``) replaces the reference's Pallas
``conv1x1_lane128``. The slab cascade applies the folded WCT through it
(:func:`..wct_transform.wct_apply_folded`).
"""

from __future__ import annotations

import torch

from . import _build
from .conv import _check_cuda

__all__ = ["conv1x1_plain", "conv1x1_bias"]

MAX_CH = 128


def conv1x1_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                  relu: bool) -> torch.Tensor:
    """Plain version: ``x @ w + b`` (+ ReLU) over the last axis of ``x``."""
    cin, cout = w.shape
    y = x.reshape(-1, cin) @ w
    if b is not None:
        y = y + b
    y = y.reshape(*x.shape[:-1], cout)
    return torch.relu(y) if relu else y


def conv1x1_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                 relu: bool) -> torch.Tensor:
    """Launch the kernel: ``x`` (..., Cin) (NHWC or (P, Cin)), ``w`` (Cin,
    Cout), ``b`` (Cout,) or None, all contiguous float32 on one CUDA device,
    Cin and Cout in 1..128 -> (..., Cout)."""
    if x.dim() < 2 or w.dim() != 2 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"conv1x1_bias: x {tuple(x.shape)} and (Cin, Cout) w "
                         f"{tuple(w.shape)} do not match")
    cin, cout = w.shape
    if not 1 <= cin <= MAX_CH or not 1 <= cout <= MAX_CH:
        raise ValueError(f"conv1x1_bias: Cin {cin}, Cout {cout} outside 1..{MAX_CH}")
    _check_cuda("conv1x1_bias", x, w, *(() if b is None else (b,)))
    if b is not None and b.shape != (cout,):
        raise ValueError(f"conv1x1_bias: bias {tuple(b.shape)} != ({cout},)")
    y = torch.empty((*x.shape[:-1], cout), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.cd_conv1x1_bias(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), x.numel() // cin, cin, cout, int(relu),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv1x1_bias")
    conv1x1_bias.launches += 1
    return y


conv1x1_bias.launches = 0
conv1x1_bias.plain = conv1x1_plain
