"""Reflect-padded 3x3 conv: the ``conv3x3_reflect`` kernel and its plain version.

The kernel (``csrc/conv3x3.cu``) replaces the reference's Pallas
``conv3x3_tiled``, ``conv3x3_subin`` and ``conv3x3_lane128`` for plain NHWC
maps. :func:`conv3x3_plain` computes the same function with PyTorch ops; the
CPU path and the tests use it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..pad import reflect_pad
from . import _build

__all__ = ["conv3x3_plain", "conv3x3_reflect"]


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                  relu: bool) -> torch.Tensor:
    """Plain version of the kernel: reflect-pad(1) + 3x3 VALID conv (+ ReLU),
    NHWC x HWIO -> NHWC."""
    y = F.conv2d(reflect_pad(x, 1).permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b)
    y = y.permute(0, 2, 3, 1).contiguous()
    return torch.relu(y) if relu else y


def conv3x3_reflect(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                    relu: bool) -> torch.Tensor:
    """Launch the kernel: ``x`` (N, H, W, Cin), ``w`` (3, 3, Cin, Cout) HWIO,
    ``b`` (Cout,) or None, all contiguous float32 on one CUDA device ->
    (N, H, W, Cout)."""
    if x.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"conv3x3_reflect: x {tuple(x.shape)} and HWIO w "
                         f"{tuple(w.shape)} do not match")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if not 1 <= cin <= 512 or not 1 <= cout <= 512:
        raise ValueError(f"conv3x3_reflect: Cin {cin}, Cout {cout} outside 1..512")
    if b is None:
        b = torch.zeros(cout, device=x.device, dtype=x.dtype)
    _check_cuda("conv3x3_reflect", x, w, b)
    if b.shape != (cout,):
        raise ValueError(f"conv3x3_reflect: bias {tuple(b.shape)} != ({cout},)")
    y = torch.empty((n, h, wd, cout), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.cd_conv3x3_reflect(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, wd,
            cin, cout, int(relu), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3x3_reflect")
    conv3x3_reflect.launches += 1
    return y


conv3x3_reflect.launches = 0
conv3x3_reflect.plain = conv3x3_plain


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous float32 tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: needs CUDA tensors on one device, got "
                             f"{[str(u.device) for u in tensors]}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: needs float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
