"""Per-pixel 1x1 conv: the ``conv1x1_bias`` kernel and its plain version.

The kernel (``csrc/conv1x1.cu``) replaces the reference's Pallas
``conv1x1_lane128``. The slab cascade applies the folded WCT through it
(:func:`..wct_transform.wct_apply_folded`). Its bfloat16 instantiation,
:func:`conv1x1_bias_bf16` (the bf16 conv3x3's persistent ring kernel with one tap),
takes a bf16 map and matrix and a float32 bias, as the reference's bf16
engine applies its folded WCT.
"""

from __future__ import annotations

import torch

from ..precision import full_float32
from . import _build
from .conv import _check_cuda, device_plan_bf16

__all__ = ["conv1x1_plain", "conv1x1_bias", "conv1x1_bias_bf16"]

MAX_CH = 128


def conv1x1_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                  relu: bool) -> torch.Tensor:
    """Plain version: ``x @ w + b`` (+ ReLU) over the last axis of ``x``. A
    bfloat16 ``x`` and ``w`` (``b`` float32): the product of the values
    upcast to float32 in full float32, bias and ReLU in float32, one
    rounding to bf16, as the bf16 kernel rounds."""
    if x.dtype == torch.bfloat16:
        with full_float32():
            y = conv1x1_plain(x.float(), w.float(), None if b is None else b.float(), relu)
        return y.to(torch.bfloat16)
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
    Cin and Cout in 1..128 -> (..., Cout). A bfloat16 ``x`` goes to
    :func:`conv1x1_bias_bf16`."""
    if x.dtype == torch.bfloat16:
        return conv1x1_bias_bf16(x, w, b, relu)
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


def conv1x1_bias_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                      relu: bool) -> torch.Tensor:
    """Launch the bf16 kernel: ``x`` (..., Cin) and ``w`` (Cin, Cout)
    bfloat16, ``b`` (Cout,) float32 or None, all contiguous on one CUDA
    device, Cin and Cout in 1..128 -> (..., Cout) bfloat16: f32 sums of the
    exact products, + b in f32, one rounding."""
    name = "conv1x1_bias_bf16"
    if x.dim() < 2 or w.dim() != 2 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and (Cin, Cout) w "
                         f"{tuple(w.shape)} do not match")
    cin, cout = w.shape
    if not 1 <= cin <= MAX_CH or not 1 <= cout <= MAX_CH:
        raise ValueError(f"{name}: Cin {cin}, Cout {cout} outside 1..{MAX_CH}")
    bias = () if b is None else (b,)
    _check_cuda(name, x, w, *bias, dtype=(torch.bfloat16, torch.bfloat16, torch.float32))
    if b is not None and b.shape != (cout,):
        raise ValueError(f"{name}: bias {tuple(b.shape)} != ({cout},)")
    y = torch.empty((*x.shape[:-1], cout), device=x.device, dtype=torch.bfloat16)
    if y.numel() == 0:
        return y
    p = x.numel() // cin
    plan = device_plan_bf16(1, 1, p, cin, cout, x.device.index, taps=1)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.cd_conv1x1_bias_bf16(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), p, cin, cout, int(relu), plan.template, plan.grid[0],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    conv1x1_bias_bf16.launches += 1
    return y


conv1x1_bias_bf16.launches = 0
conv1x1_bias_bf16.plain = conv1x1_plain
