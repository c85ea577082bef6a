"""JPEG-native YCbCr 4:2:0 transport at the host boundary.

The pipeline's endpoints are JPEGs, whose native form is YCbCr with 2x2
chroma subsampling: 1.5 bytes per pixel against RGB's 3. The conversions
use the JFIF full-range BT.601 matrices (what libjpeg uses), so a decoded
JPEG round-trips with only the chroma box filter's and the rounding's error.

The host converters prefer the native fixed-point loop of
:mod:`..data.native_codec` (within one level of the numpy formula) and fall
back to numpy where the codec is unavailable. The device converters are
plain torch on the tensor's own device: the reference's are XLA, not Pallas.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data import native_codec

__all__ = ["rgb_to_yuv420_host", "yuv420_to_rgb_host", "yuv420_to_rgbf_device",
           "rgbf_to_yuv420_device"]


def rgb_to_yuv420_host(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, H, W, 3) uint8 RGB -> (Y (N, H, W) u8, CbCr (N, H/2, W/2, 2) u8).
    H and W must be even (pad with edge rows first)."""
    n, h, w, _ = rgb.shape
    if h % 2 or w % 2:
        raise ValueError(f"4:2:0 planes need an even height and width, got {h}x{w}")
    if rgb.dtype == np.uint8:
        outs = [native_codec.rgb_to_yuv420(rgb[i]) for i in range(n)]
        if all(o is not None for o in outs):
            if n == 1:  # a view, not a stacked copy
                return outs[0][0][None], outs[0][1][None]
            return np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs])
    x = rgb.astype(np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    cbcr = np.stack([cb, cr], axis=-1).reshape(n, h // 2, 2, w // 2, 2, 2)
    cbcr = cbcr.mean(axis=(2, 4))  # 2x2 box filter (JPEG-style subsampling)
    y8 = np.clip(y + 0.5, 0, 255).astype(np.uint8)
    c8 = np.clip(cbcr + 0.5, 0, 255).astype(np.uint8)
    return y8, c8


def yuv420_to_rgb_host(y: np.ndarray, cbcr: np.ndarray) -> np.ndarray:
    """Inverse of :func:`rgb_to_yuv420_host` (nearest chroma upsample)."""
    n = y.shape[0]
    if y.dtype == np.uint8 and cbcr.dtype == np.uint8:
        outs = [native_codec.yuv420_to_rgb(y[i], cbcr[i]) for i in range(n)]
        if all(o is not None for o in outs):
            return outs[0][None] if n == 1 else np.stack(outs)
    c = cbcr.astype(np.float32).repeat(2, axis=1).repeat(2, axis=2)
    yf = y.astype(np.float32)
    cb = c[..., 0] - 128.0
    cr = c[..., 1] - 128.0
    r = yf + 1.402 * cr
    g = yf - 0.344136 * cb - 0.714136 * cr
    b = yf + 1.772 * cb
    out = np.stack([r, g, b], axis=-1)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def yuv420_to_rgbf_device(y: torch.Tensor, cbcr: torch.Tensor) -> torch.Tensor:
    """(N, H, W) u8 + (N, H/2, W/2, 2) u8 -> (N, H, W, 3) float32 in [0, 1],
    on the planes' device."""
    yf = y.float()
    c = cbcr.float().repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    cb = c[..., 0] - 128.0
    cr = c[..., 1] - 128.0
    r = yf + 1.402 * cr
    g = yf - 0.344136 * cb - 0.714136 * cr
    b = yf + 1.772 * cb
    return torch.clamp(torch.stack([r, g, b], dim=-1) / 255.0, 0.0, 1.0)


def rgbf_to_yuv420_device(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, 3) float [0, 1] -> (Y u8, CbCr u8) on the image's device;
    H and W even."""
    x = torch.clamp(img.float(), 0.0, 1.0) * 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    n, h, w = y.shape
    cbcr = torch.stack([cb, cr], dim=-1).reshape(n, h // 2, 2, w // 2, 2, 2)
    cbcr = cbcr.mean(dim=(2, 4))
    y8 = torch.clamp(y + 0.5, 0, 255).to(torch.uint8)
    c8 = torch.clamp(cbcr + 0.5, 0, 255).to(torch.uint8)
    return y8, c8
