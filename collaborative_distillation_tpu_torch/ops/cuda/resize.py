"""The shorter-side resize of a decoded JPEG: the kernels and their plain versions.

``csrc/jpeg_resize.cu`` replaces no TPU kernel: it is the card's counterpart
of the reference's host codec (``native/imgcodec.cpp``), whose training
loader lets libjpeg decode at scale 1/d and then box-resizes
(``cd_resize_rgb``). nvJPEG decodes only whole images, so the card runs
:func:`scale_reduce_u8` (the stand-in for libjpeg's scaled IDCT) and then
:func:`box_resize_u8` (``cd_resize_rgb`` bit for bit) on the decode; see
``data/jpeg.py:decode_jpeg_shorter_side`` for the chain. Both take and give
(H, W, 3) uint8 RGB. A CPU tensor takes the plain version (integer tensor
ops), a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import threading

import torch

from . import _build

__all__ = ["scale_reduce_plain", "box_resize_plain", "scale_reduce_u8", "box_resize_u8"]

MAX_DENOM = 8   # libjpeg's coarsest scale, 1/8
_count = threading.Lock()   # the Loader's threads launch these together


def scale_reduce_plain(x: torch.Tensor, denom: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> (ceil(H/d), ceil(W/d), 3) uint8: each pixel the
    mean of its d x d block, rounded as ``(sum + n // 2) // n`` (n = d * d),
    the last row and column of blocks reading the image's last row and
    column where they pass its edge."""
    h, w, _ = x.shape
    ho, wo = -(-h // denom), -(-w // denom)
    rows = torch.arange(ho * denom, device=x.device).clamp_(max=h - 1)
    cols = torch.arange(wo * denom, device=x.device).clamp_(max=w - 1)
    blocks = x.index_select(0, rows).index_select(1, cols).to(torch.int32)
    s = blocks.reshape(ho, denom, wo, denom, 3).sum((1, 3))
    n = denom * denom
    return torch.div(s + n // 2, n, rounding_mode="floor").to(torch.uint8)


def _windows(src: int, dst: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``cd_resize_rgb``'s window bounds along one axis: [i*src/dst,
    (i+1)*src/dst) in integer division, at least one pixel wide."""
    i = torch.arange(dst, device=device, dtype=torch.int64)
    lo = torch.div(i * src, dst, rounding_mode="floor")
    hi = torch.maximum(torch.div((i + 1) * src, dst, rounding_mode="floor"), lo + 1)
    return lo, hi


def box_resize_plain(x: torch.Tensor, dw: int, dh: int) -> torch.Tensor:
    """(sh, sw, 3) uint8 -> (dh, dw, 3) uint8 as ``cd_resize_rgb``: each
    channel's window sum (a summed-area table in int64) divided by the
    window's pixel count with truncation."""
    sh, sw, _ = x.shape
    y0, y1 = _windows(sh, dh, x.device)
    x0, x1 = _windows(sw, dw, x.device)
    sat = torch.zeros((sh + 1, sw + 1, 3), dtype=torch.int64, device=x.device)
    sat[1:, 1:] = x.to(torch.int64).cumsum(0).cumsum(1)
    total = (sat[y1][:, x1] - sat[y0][:, x1] - sat[y1][:, x0] + sat[y0][:, x0])
    n = ((y1 - y0)[:, None] * (x1 - x0)[None, :])[..., None]
    return torch.div(total, n, rounding_mode="floor").to(torch.uint8)


def _check(name: str, x: torch.Tensor) -> bool:
    """Whether ``x`` goes to the kernel (CUDA) rather than the plain
    version (CPU); raises on what neither takes."""
    if x.dtype != torch.uint8:
        raise ValueError(f"{name}: needs uint8, got {x.dtype}")
    if x.dim() != 3 or x.shape[2] != 3:
        raise ValueError(f"{name}: needs (H, W, 3) RGB, got {tuple(x.shape)}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: runs on 'cuda' or 'cpu', got {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous tensor")
    return x.device.type == "cuda"


def _sizes(name: str, *sizes: int) -> None:
    if any(s < 1 for s in sizes):
        raise ValueError(f"{name}: sizes must be positive, got {sizes}")


def _launch(wrapper, fn: str, x: torch.Tensor, out_shape, *args: int) -> torch.Tensor:
    y = torch.empty(out_shape, dtype=torch.uint8, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = getattr(lib, fn)(x.data_ptr(), y.data_ptr(), *args,
                               torch.cuda.current_stream().cuda_stream)
    _build.check(err, wrapper.__name__)
    with _count:
        wrapper.launches += 1
    return y


def scale_reduce_u8(x: torch.Tensor, denom: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> (ceil(H/d), ceil(W/d), 3) uint8, the rounded mean
    of each d x d block (1 <= d <= 8); on a CUDA tensor the kernel."""
    name = "scale_reduce_u8"
    card = _check(name, x)
    if int(denom) != denom or not 1 <= denom <= MAX_DENOM:
        raise ValueError(f"{name}: denom must be an integer 1..{MAX_DENOM}, got {denom}")
    denom = int(denom)
    h, w, _ = x.shape
    _sizes(name, h, w)
    if not card:
        return scale_reduce_plain(x, denom)
    return _launch(scale_reduce_u8, "cd_scale_reduce_u8", x,
                   (-(-h // denom), -(-w // denom), 3), h, w, denom)


def box_resize_u8(x: torch.Tensor, dw: int, dh: int) -> torch.Tensor:
    """(sh, sw, 3) uint8 -> (dh, dw, 3) uint8, ``cd_resize_rgb``'s box
    filter; on a CUDA tensor the kernel."""
    name = "box_resize_u8"
    card = _check(name, x)
    sh, sw, _ = x.shape
    _sizes(name, sh, sw, dw, dh)
    if not card:
        return box_resize_plain(x, dw, dh)
    return _launch(box_resize_u8, "cd_box_resize_u8", x, (dh, dw, 3), sh, sw, dh, dw)


scale_reduce_u8.launches = 0
scale_reduce_u8.plain = scale_reduce_plain
box_resize_u8.launches = 0
box_resize_u8.plain = box_resize_plain
