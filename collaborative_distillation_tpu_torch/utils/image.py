"""Image files: read, write and resize without PIL.

PNG is the port's own (:mod:`..data.png`); JPEG goes through the codec of
the device the caller names (:mod:`..data.jpeg`): libjpeg for ``"cpu"``,
nvJPEG for a CUDA device, the card when ``device`` is None, as every other
entry point's default. Arrays in and out are host numpy arrays on either
device. Where the device's codec cannot load, reading a JPEG raises
:class:`CodecUnavailable` with the file's name and the codec's reason, and
so does writing to a ``.jpg`` path: callers that want PNG there ask for it
(:func:`jpeg_or_png`).

:func:`resize` reproduces ``PIL.Image.resize`` with its default filter for
RGB, antialiased bicubic (a = -0.5, support scaled by the downscale
factor), or with ``resample="bilinear"`` PIL's BILINEAR (the triangle,
support 1, scaled alike), in PIL's fixed point: 22-bit coefficients, the
horizontal pass rounded to uint8, then the vertical one.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..data import jpeg
from ..data.jpeg import CodecUnavailable
from ..data.jpeg_header import jpeg_dims
from ..data.native_codec import MAX_DECODE_PIXELS
from ..data.png import PNG_SIGNATURE, decode_png, encode_png

__all__ = ["CodecUnavailable", "decode_image", "read_image", "resize", "jpeg_or_png",
           "save_image", "save_image_grid", "load_image_array"]

_JPEG_EXT = (".jpg", ".jpeg")
_PRECISION_BITS = 22   # PIL's Resample.c: 32 - 8 bits of a sample - 2 of headroom


def _to_uint8(arr: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(arr, np.float32), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def decode_image(data: bytes, *, name: str = "image",
                 max_pixels: int | None = MAX_DECODE_PIXELS, device=None) -> np.ndarray:
    """PNG or JPEG bytes -> (H, W, 3) uint8 RGB on the host, a JPEG decoded
    by ``device``'s codec. Images over ``max_pixels`` (the
    decompression-bomb cap, for untrusted bodies) are refused."""
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, max_pixels=max_pixels)
    if data.startswith(b"\xff\xd8"):
        jpeg.require(device, f"read JPEG {name}")
        out = jpeg.decode_jpeg(data, device, max_pixels=max_pixels or 1 << 62)
        if out is None:
            dims = jpeg_dims(data)
            why = ("a bad header" if dims is None else
                   f"{dims[0]}x{dims[1]} pixels, over the {max_pixels}-pixel limit"
                   if max_pixels and dims[0] * dims[1] > max_pixels else "corrupt data")
            raise ValueError(f"cannot decode JPEG {name}: {why}")
        if isinstance(out, np.ndarray):
            return out
        from .transfer import fetch
        return fetch(out)
    raise ValueError(f"{name} is neither a PNG nor a JPEG file")


def read_image(path: str, *, device=None) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB (a JPEG decoded by ``device``'s
    codec)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), name=path, device=device)


def _bicubic(t: np.ndarray) -> np.ndarray:
    return np.where(t < 1.0, (1.5 * t - 2.5) * t * t + 1,
                    np.where(t < 2.0, (((t - 5) * t + 8) * t - 4) * -0.5, 0.0))


def _bilinear(t: np.ndarray) -> np.ndarray:
    return np.where(t < 1.0, 1.0 - t, 0.0)


_FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}   # (filter, support)


def _coeffs(in_size: int, out_size: int, resample: str = "bicubic"):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    bicubic or bilinear filter: the first input index of each output and its
    fixed-point weights (out_size, ksize), zero past the window's end."""
    fn, fsupport = _FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = fsupport * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    t = np.abs(((x[None] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = fn(t)
    w = np.where(x[None] < xmax[:, None], w, 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]   # in order, as the C loop sums
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << _PRECISION_BITS)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + x[None], in_size - 1)
    return idx, fixed


def _resample(img: np.ndarray, axis: int, out_size: int, resample: str) -> np.ndarray:
    """One pass of PIL's 8-bit resampling along ``axis`` (0 rows, 1 columns)."""
    idx, k = _coeffs(img.shape[axis], out_size, resample)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = None
    for j in range(k.shape[1]):
        term = np.take(img, idx[:, j], axis=axis).astype(np.int64) * k[:, j].reshape(shape)
        acc = term + (1 << (_PRECISION_BITS - 1)) if acc is None else acc + term
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, width: int, height: int, resample: str = "bicubic") -> np.ndarray:
    """(H, W, 3) uint8 -> (height, width, 3) uint8, as PIL's
    ``Image.fromarray(img).resize((width, height))`` computes it, or with
    ``resample="bilinear"`` as ``.resize((width, height), Image.BILINEAR)``."""
    if width <= 0 or height <= 0:
        raise ValueError(f"resize to {width}x{height}: height and width must be > 0")
    if resample not in _FILTERS:
        raise ValueError(f"resample {resample!r}: the port has {sorted(_FILTERS)}")
    h, w = img.shape[:2]
    if w != width:
        img = _resample(img, 1, width, resample)
    if h != height:
        img = _resample(img, 0, height, resample)
    return img if (w, h) != (width, height) else img.copy()


def jpeg_or_png(path: str, *, device=None) -> tuple[str, str | None]:
    """``path``, or where it names a JPEG and ``device``'s codec is
    unavailable, the same stem as ``.png`` and the codec's reason."""
    stem, ext = os.path.splitext(path)
    if ext.lower() in _JPEG_EXT and not jpeg.available(device):
        return stem + ".png", jpeg.unavailable_reason(device)
    return path, None


def save_image(arr: np.ndarray, path: str, *, quality: int = 95, device=None) -> None:
    """(H, W, 3) float [0, 1] or uint8 -> a ``.png``, ``.jpg`` or ``.jpeg``
    file, a JPEG encoded by ``device``'s codec. A JPEG path where that codec
    is unavailable raises :class:`CodecUnavailable` (see :func:`jpeg_or_png`)."""
    u8 = arr if (isinstance(arr, np.ndarray) and arr.dtype == np.uint8) else _to_uint8(arr)
    ext = os.path.splitext(path)[1].lower()
    if ext in _JPEG_EXT:
        jpeg.require(device, f"write JPEG {path}")
        data = jpeg.encode_jpeg(np.ascontiguousarray(u8), device, quality=quality)
        if data is None:
            raise CodecUnavailable(f"cannot write JPEG {path}: encode failed")
    elif ext == ".png":
        data = encode_png(u8)
    else:
        raise ValueError(f"cannot write {path}: the port writes .png, .jpg and .jpeg")
    with open(path, "wb") as fh:
        fh.write(data)


def save_image_grid(batch: np.ndarray, path: str, *, nrow: int = 8, pad: int = 2,
                    device=None) -> None:
    """(N, H, W, 3) -> a tiled grid image, ``nrow`` images a row
    (torchvision ``make_grid``); a JPEG encoded by ``device``'s codec."""
    batch = _to_uint8(batch)
    n, h, w, c = batch.shape
    ncol = min(nrow, n)
    nrows = -(-n // ncol)
    grid = np.zeros((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        y, x = r * (h + pad) + pad, col * (w + pad) + pad
        grid[y: y + h, x: x + w] = batch[i]
    save_image(grid, path, device=device)


def load_image_array(path: str, *, resize_shorter: int = 0, device=None) -> np.ndarray:
    """An image file -> (H, W, 3) float32 in [0, 1], its shorter side
    resized to ``resize_shorter`` when given (a JPEG decoded by ``device``'s
    codec)."""
    img = read_image(path, device=device)
    if resize_shorter:
        h, w = img.shape[:2]
        if w < h:
            img = resize(img, resize_shorter, int(h * resize_shorter / w))
        else:
            img = resize(img, int(w * resize_shorter / h), resize_shorter)
    return img.astype(np.float32) / 255.0
