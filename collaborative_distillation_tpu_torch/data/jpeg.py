"""The JPEG codec of a device: libjpeg for the CPU, nvJPEG for the card.

Every JPEG the port reads or writes goes through the codec of the device
the work runs on, as every kernel does: :mod:`.native_codec` (libjpeg, on
the host) for ``"cpu"``, :mod:`.nvjpeg_codec` (on the card) for a CUDA
device. ``device=None`` means the card. A CUDA device never falls back to
libjpeg and a CPU device never uses nvJPEG: where the device's codec cannot
load, these functions raise :class:`CodecUnavailable` with that codec's
reason. Data the codec refuses (a bad header, corrupt entropy data, a size
over ``max_pixels``) gives None, as the codecs' own functions do.

Arrays come and go in the device's form: numpy on the host for the CPU,
torch tensors on the card for CUDA (host arrays given to a CUDA device are
copied up first).

:func:`decode_jpeg_shorter_side` is the training loader's decode: on the
CPU libjpeg's DCT-scaled decode and box resize (the reference's, exactly);
on the card nvJPEG's whole decode, then :func:`to_shorter_side`, which
reproduces the reference's two steps with the kernels of
``ops/cuda/resize.py`` (the scaled IDCT by a rounded block mean, within
~50 dB; the box resize bit for bit).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda.resize import box_resize_u8, scale_reduce_u8
from . import native_codec, nvjpeg_codec
from .native_codec import shorter_side_plan

__all__ = ["CodecUnavailable", "codec", "codec_name", "available",
           "unavailable_reason", "require", "decode_jpeg", "decode_jpeg_yuv420", "encode_jpeg",
           "encode_jpeg_yuv420", "shorter_side_plan", "to_shorter_side",
           "decode_jpeg_shorter_side"]


class CodecUnavailable(RuntimeError):
    """A JPEG was to be read or written on a device whose codec cannot load."""


def _device(device) -> torch.device:
    """``None`` is the card; the port runs on ``cuda`` or ``cpu``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {dev}")
    return dev


def codec(device=None):
    """The codec module of ``device``: ``nvjpeg_codec`` or ``native_codec``."""
    return nvjpeg_codec if _device(device).type == "cuda" else native_codec


def codec_name(device=None) -> str:
    return "nvjpeg" if _device(device).type == "cuda" else "libjpeg"


def available(device=None) -> bool:
    return codec(device).available()


def unavailable_reason(device=None) -> str | None:
    return codec(device).unavailable_reason()


def require(device=None, what: str = "code a JPEG"):
    """The device's codec module; raises :class:`CodecUnavailable` saying
    why where it cannot load."""
    mod = codec(device)
    if not mod.available():
        raise CodecUnavailable(f"cannot {what}: {mod.unavailable_reason()}")
    return mod


def _on(x, dev: torch.device) -> torch.Tensor:
    from ..utils.transfer import push
    return push(x, dev) if isinstance(x, np.ndarray) else x.to(dev)


def decode_jpeg(data: bytes, device=None, *, max_pixels: int | None = None):
    """JPEG bytes -> (H, W, 3) uint8 RGB in the device's form; None where
    the data does not decode or claims more than ``max_pixels`` (default
    ``MAX_DECODE_PIXELS``)."""
    dev = _device(device)
    mod = require(dev, "read a JPEG")
    kw = {} if max_pixels is None else {"max_pixels": max_pixels}
    if dev.type == "cuda":
        return mod.decode_jpeg(data, dev, **kw)
    return mod.decode_jpeg(data, **kw)


def decode_jpeg_yuv420(data: bytes, device=None, *, max_pixels: int | None = None):
    """JPEG bytes -> its 4:2:0 planes (Y (H, W), CbCr (H/2, W/2, 2) uint8)
    in the device's form; None where the file is not an even-sized baseline
    4:2:0 JPEG, does not decode, or claims more than ``max_pixels``."""
    dev = _device(device)
    mod = require(dev, "read a JPEG")
    kw = {} if max_pixels is None else {"max_pixels": max_pixels}
    if dev.type == "cuda":
        return mod.decode_jpeg_yuv420(data, dev, **kw)
    return mod.decode_jpeg_yuv420(data, **kw)


def encode_jpeg(rgb, device=None, *, quality: int = 95) -> bytes | None:
    """(H, W, 3) uint8 RGB, host or device -> baseline JPEG bytes (4:2:0),
    encoded on ``device``; None where the array is not that."""
    dev = _device(device)
    mod = require(dev, "write a JPEG")
    if dev.type == "cuda":
        return mod.encode_jpeg(_on(rgb, dev), quality=quality)
    return mod.encode_jpeg(np.ascontiguousarray(rgb), quality=quality)


def encode_jpeg_yuv420(y, cbcr, device=None, *, quality: int = 95) -> bytes | None:
    """4:2:0 planes, host or device -> baseline JPEG bytes, encoded on
    ``device``; None where the planes do not fit together."""
    dev = _device(device)
    mod = require(dev, "write a JPEG")
    if dev.type == "cuda":
        return mod.encode_jpeg_yuv420(_on(y, dev), _on(cbcr, dev), quality=quality)
    return mod.encode_jpeg_yuv420(np.asarray(y), np.asarray(cbcr), quality=quality)


def to_shorter_side(rgb: torch.Tensor, shorter_side: int) -> torch.Tensor:
    """A whole decode, (H, W, 3) uint8 -> the reference's shorter-side image
    on the same device: the block mean at ``denom`` (where it is over 1),
    then the box resize (where the size changes). On the card the kernels
    ``scale_reduce_u8`` and ``box_resize_u8``, on the CPU their plain
    versions."""
    denom, scaled, (dh, dw) = shorter_side_plan(rgb.shape[0], rgb.shape[1], shorter_side)
    if denom > 1:
        rgb = scale_reduce_u8(rgb, denom)
    return rgb if (dh, dw) == scaled else box_resize_u8(rgb, dw, dh)


def decode_jpeg_shorter_side(data: bytes, shorter_side: int, device=None):
    """JPEG bytes -> (H, W, 3) uint8 RGB whose shorter side is
    ``shorter_side``, in the device's form; None where the data does not
    decode. On the CPU libjpeg decodes at scale 1/denom and box-resizes
    (the reference's own path); on a CUDA device nvJPEG decodes whole and
    :func:`to_shorter_side` runs on the card, on the caller's current
    stream. Raises :class:`CodecUnavailable` where the device's codec
    cannot load."""
    dev = _device(device)
    mod = require(dev, "read a JPEG")
    if dev.type == "cpu":
        return mod.decode_jpeg_shorter_side(data, shorter_side)
    img = mod.decode_jpeg(data, dev)
    return None if img is None else to_shorter_side(img, shorter_side)
