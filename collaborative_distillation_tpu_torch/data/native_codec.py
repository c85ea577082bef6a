"""ctypes binding for the repository's native image codec (``native/imgcodec.cpp``).

The port's own copy of the reference package's binding: RGB JPEG decode
(optionally DCT-scaled) and encode, the box resize behind
:func:`decode_jpeg_shorter_side`, YCbCr 4:2:0 conversions, whole-plane JPEG
decode and encode, and the incremental plane reader and writer. The shared
object is built at first use with ``g++ -O3 -fPIC -shared ... -ljpeg`` into
``build/torch_kernels/imgcodec-<source hash>/`` at the repository root
(never into ``native/``), so a fresh checkout builds itself.

Where ``g++`` or libjpeg is missing the codec is unavailable: every function
returns None, :func:`available` is False and :func:`unavailable_reason` says
why, with the compiler's own output. Nothing falls back to another library;
callers take their whole-image paths instead. The C calls release the GIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "unavailable_reason", "jpeg_dims", "decode_jpeg",
           "decode_jpeg_shorter_side", "encode_jpeg", "decode_jpeg_yuv420", "encode_jpeg_yuv420",
           "jpeg_yuv420_reader", "jpeg_yuv420_writer", "rgb_to_yuv420", "yuv420_to_rgb",
           "MAX_DECODE_PIXELS"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "imgcodec.cpp")
_CMD = ["g++", "-O3", "-fPIC", "-shared"]
# decompression-bomb guard for untrusted inputs: a few-KB JPEG can claim
# 65500x65500 pixels (a 4.3 GB Y plane); the reference's default cap
MAX_DECODE_PIXELS = 178956970

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_PI = ctypes.POINTER(ctypes.c_int)
# (argtypes, restype) of every C entry point used here
_SIGNATURES = {
    "cd_jpeg_dims": ([ctypes.c_char_p, _L, _I, _PI, _PI], _I),
    "cd_jpeg_decode": ([ctypes.c_char_p, _L, _I, _P, _I, _I], _I),
    "cd_jpeg_encode": ([_P, _I, _I, _I, _P, _L], _L),
    "cd_resize_rgb": ([_P, _I, _I, _P, _I, _I], _I),
    "cd_rgb_to_yuv420": ([_P, _I, _I, _P, _P], _I),
    "cd_yuv420_to_rgb": ([_P, _P, _I, _I, _P], _I),
    "cd_jpeg_decode_yuv420": ([ctypes.c_char_p, _L, _P, _P, _I, _I], _I),
    "cd_jpeg_encode_yuv420": ([_P, _P, _I, _I, _I, _P, _L], _L),
    "cd_jpeg_enc_begin": ([_I, _I, _I], _P),
    "cd_jpeg_enc_rows": ([_P, _P, _P, _I], _L),
    "cd_jpeg_enc_finish": ([_P], _L),
    "cd_jpeg_enc_read_free": ([_P, _P, _L], _L),
    "cd_jpeg_enc_abort": ([_P], None),
    "cd_jpeg_dec_begin": ([ctypes.c_char_p, _L, _PI, _PI], _P),
    "cd_jpeg_dec_rows": ([_P, _P, _P, _I], _L),
    "cd_jpeg_dec_abort": ([_P], None),
}

_lock = threading.Lock()
_lib = None
_reason: str | None = None   # why the codec is unavailable, once it was tried


def build_dir() -> str:
    """``build/torch_kernels/imgcodec-<hash of the source and flags>``."""
    h = hashlib.sha256(" ".join(_CMD).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_REPO, "build", "torch_kernels", "imgcodec-" + h.hexdigest()[:16])


def _build() -> str:
    """The shared object's path, compiled first if this source has none."""
    out_dir = build_dir()
    so = os.path.join(out_dir, "libimgcodec.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            r = subprocess.run([*_CMD, "-o", tmp, _SRC, "-ljpeg"], capture_output=True,
                               text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"g++ could not run: {e}") from e
        if r.returncode:
            raise RuntimeError(f"g++ exited {r.returncode}: {(r.stderr or r.stdout).strip()}")
        os.replace(tmp, so)   # atomic publish
    return so


def _load():
    global _lib, _reason
    if _lib is not None or _reason is not None:
        return _lib
    with _lock:
        if _lib is not None or _reason is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            _lib = lib
        except (OSError, RuntimeError, AttributeError) as e:
            _reason = f"native codec unavailable: {e}"
    return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str | None:
    """None where the codec loaded; else why not (the compiler's output)."""
    _load()
    return _reason


def _dims(lib, data: bytes, scale_denom: int = 1):
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.cd_jpeg_dims(data, len(data), scale_denom, ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _encoded(call, w: int, h: int) -> bytes | None:
    """Run a ``cd_jpeg_encode*`` entry point into a worst-case buffer, with
    one 2x retry when libjpeg had to grow it (-2); None on failure."""
    cap, n = w * h * 3 + (1 << 16), -2
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        n = call(_ptr(out), cap)
        if n != -2:
            break
        cap *= 2
    return out[:n].tobytes() if n > 0 else None


def jpeg_dims(data: bytes) -> tuple[int, int] | None:
    """JPEG bytes -> (width, height) from the header alone; None when the
    codec is unavailable or the header is bad."""
    lib = _load()
    return None if lib is None else _dims(lib, data)


def decode_jpeg(data: bytes, scale_denom: int = 1, *,
                max_pixels: int | None = None) -> np.ndarray | None:
    """JPEG bytes -> (H, W, 3) uint8 RGB, optionally DCT-scaled by
    1/``scale_denom`` (1, 2, 4 or 8). None when the codec is unavailable,
    the data does not decode, or the claimed size exceeds ``max_pixels``
    (default MAX_DECODE_PIXELS)."""
    lib = _load()
    if lib is None:
        return None
    dims = _dims(lib, data, scale_denom)
    limit = MAX_DECODE_PIXELS if max_pixels is None else max_pixels
    if dims is None or dims[0] * dims[1] > limit:
        return None
    w, h = dims
    out = np.empty((h, w, 3), np.uint8)
    if lib.cd_jpeg_decode(data, len(data), scale_denom, _ptr(out), w, h) != 0:
        return None
    return out


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes | None:
    """(H, W, 3) uint8 RGB -> baseline JPEG bytes (libjpeg's default 4:2:0);
    None when the codec is unavailable or the array is not that."""
    lib = _load()
    if lib is None or rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        return None
    rgb = np.ascontiguousarray(rgb)
    h, w = rgb.shape[:2]
    return _encoded(lambda buf, cap: lib.cd_jpeg_encode(_ptr(rgb), w, h, quality, buf, cap),
                    w, h)


def decode_jpeg_shorter_side(data: bytes, shorter_side: int) -> np.ndarray | None:
    """Decode and resize so that min(H, W) == ``shorter_side``: the coarsest
    DCT scale that still over-resolves the target, then a box-filter
    resize. None when the codec is unavailable or the data does not decode."""
    lib = _load()
    if lib is None:
        return None
    dims = _dims(lib, data)
    if dims is None:
        return None
    denom = 1
    while denom < 8 and min(dims) // (denom * 2) >= shorter_side:
        denom *= 2
    arr = decode_jpeg(data, denom)
    if arr is None:
        return None
    sh, sw = arr.shape[:2]
    if sw < sh:
        dw, dh = shorter_side, max(1, round(sh * shorter_side / sw))
    else:
        dh, dw = shorter_side, max(1, round(sw * shorter_side / sh))
    if (dw, dh) == (sw, sh):
        return arr
    dst = np.empty((dh, dw, 3), np.uint8)
    if lib.cd_resize_rgb(_ptr(arr), sw, sh, _ptr(dst), dw, dh) != 0:
        return None
    return dst


def decode_jpeg_yuv420(data: bytes, *, max_pixels: int | None = None
                       ) -> tuple[np.ndarray, np.ndarray] | None:
    """JPEG bytes -> (Y (H, W) u8, CbCr (H/2, W/2, 2) u8), the planes read
    straight out of the file with no colour conversion. None when the codec
    is unavailable, the file is not an even-sized baseline 4:2:0 JPEG, or
    its claimed size exceeds ``max_pixels`` (default MAX_DECODE_PIXELS)."""
    lib = _load()
    if lib is None:
        return None
    dims = _dims(lib, data)
    if dims is None:
        return None
    w, h = dims
    limit = MAX_DECODE_PIXELS if max_pixels is None else max_pixels
    if w % 2 or h % 2 or w * h > limit:
        return None
    y = np.empty((h, w), np.uint8)
    cbcr = np.empty((h // 2, w // 2, 2), np.uint8)
    if lib.cd_jpeg_decode_yuv420(data, len(data), _ptr(y), _ptr(cbcr), w, h) != 0:
        return None
    return y, cbcr


def encode_jpeg_yuv420(y: np.ndarray, cbcr: np.ndarray, quality: int = 95) -> bytes | None:
    """(Y, CbCr) 4:2:0 planes -> JPEG bytes (the planes are what the file
    stores); None when unavailable or the planes do not fit together."""
    lib = _load()
    if lib is None or y.dtype != np.uint8 or cbcr.dtype != np.uint8 or y.ndim != 2:
        return None
    h, w = y.shape
    if h % 2 or w % 2 or cbcr.shape != (h // 2, w // 2, 2):
        return None
    y, cbcr = np.ascontiguousarray(y), np.ascontiguousarray(cbcr)
    return _encoded(lambda buf, cap: lib.cd_jpeg_encode_yuv420(_ptr(y), _ptr(cbcr), w, h,
                                                               quality, buf, cap), w, h)


class _JpegYuv420Writer:
    """Incremental 4:2:0-plane JPEG encoder (see :func:`jpeg_yuv420_writer`).

    Feed row bands in order with :meth:`write`, then :meth:`finish` for the
    bytes. Band heights must be even and multiples of 16 except the last.
    After any failure the writer is dead (``finish`` returns None). The bytes
    equal :func:`encode_jpeg_yuv420` of the whole planes.
    """

    def __init__(self, lib, w: int, h: int, quality: int):
        self._lib = lib
        self._h = h
        self._w = w
        self._written = 0
        self._handle = lib.cd_jpeg_enc_begin(w, h, quality)
        if not self._handle:
            raise RuntimeError(f"jpeg encoder rejected {w}x{h} q{quality}")

    def write(self, y: np.ndarray, cbcr: np.ndarray) -> bool:
        """Append one band; returns False (and kills the writer) on error."""
        if not self._handle:
            return False
        rows = y.shape[0]
        if (y.dtype != np.uint8 or cbcr.dtype != np.uint8 or y.ndim != 2
                or y.shape[1] != self._w or cbcr.shape != (rows // 2, self._w // 2, 2)):
            self.close()
            return False
        y, cbcr = np.ascontiguousarray(y), np.ascontiguousarray(cbcr)
        if self._lib.cd_jpeg_enc_rows(self._handle, _ptr(y), _ptr(cbcr), rows) != 0:
            self._handle = None  # the C side freed it
            return False
        self._written += rows
        return True

    def finish(self) -> bytes | None:
        if not self._handle or self._written != self._h:
            self.close()
            return None
        n = self._lib.cd_jpeg_enc_finish(self._handle)
        if n <= 0:
            self._handle = None
            return None
        out = np.empty(n, np.uint8)
        rc = self._lib.cd_jpeg_enc_read_free(self._handle, _ptr(out), int(n))
        self._handle = None
        return out[:rc].tobytes() if rc > 0 else None

    def close(self) -> None:
        if self._handle:
            self._lib.cd_jpeg_enc_abort(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class _JpegYuv420Reader:
    """Incremental 4:2:0-plane JPEG decoder (see :func:`jpeg_yuv420_reader`).

    :meth:`read` returns the next band's ``(y, cbcr)`` planes, or None on
    error (the reader is then dead); ``done`` turns True after the last
    band. Band heights must be even and multiples of 16 except the last.
    """

    def __init__(self, lib, data: bytes, handle, w: int, h: int):
        self._lib = lib
        self._data = data  # the handle reads from this buffer: keep it alive
        self._handle = handle
        self.w = w
        self.h = h
        self._row = 0
        self.done = False

    def read(self, rows: int) -> tuple[np.ndarray, np.ndarray] | None:
        if not self._handle or self.done:
            return None
        rows = min(rows, self.h - self._row)
        y = np.empty((rows, self.w), np.uint8)
        cbcr = np.empty((rows // 2, self.w // 2, 2), np.uint8)
        rc = self._lib.cd_jpeg_dec_rows(self._handle, _ptr(y), _ptr(cbcr), rows)
        if rc < 0:
            self._handle = None  # the C side freed it
            return None
        self._row += rows
        if rc == 1:
            self._handle = None  # complete: freed by the C side
            self.done = True
        return y, cbcr

    def close(self) -> None:
        if self._handle:
            self._lib.cd_jpeg_dec_abort(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def jpeg_yuv420_reader(data: bytes, *, max_pixels: int | None = None
                       ) -> _JpegYuv420Reader | None:
    """Incremental decoder; None unless ``data`` is an even-sized baseline
    4:2:0 JPEG within the decompression-bomb limit and the codec is
    available."""
    lib = _load()
    if lib is None:
        return None
    dims = _dims(lib, data)
    limit = MAX_DECODE_PIXELS if max_pixels is None else max_pixels
    if dims is None or dims[0] * dims[1] > limit:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    handle = lib.cd_jpeg_dec_begin(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if not handle:
        return None
    return _JpegYuv420Reader(lib, data, handle, w.value, h.value)


def jpeg_yuv420_writer(w: int, h: int, quality: int = 95) -> _JpegYuv420Writer | None:
    """Incremental encoder; None when the codec is unavailable or the size is
    not even."""
    lib = _load()
    if lib is None or w <= 0 or h <= 0 or w % 2 or h % 2:
        return None
    try:
        return _JpegYuv420Writer(lib, w, h, quality)
    except RuntimeError:
        return None


def rgb_to_yuv420(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """(H, W, 3) u8, H and W even -> (Y (H, W) u8, CbCr (H/2, W/2, 2) u8),
    JFIF full-range BT.601 with 2x2 box chroma in fixed point (within one
    level of the numpy formula). None if unavailable."""
    lib = _load()
    if lib is None or rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        return None
    h, w = rgb.shape[:2]
    if h % 2 or w % 2:
        return None
    rgb = np.ascontiguousarray(rgb)
    y = np.empty((h, w), np.uint8)
    cbcr = np.empty((h // 2, w // 2, 2), np.uint8)
    if lib.cd_rgb_to_yuv420(_ptr(rgb), h, w, _ptr(y), _ptr(cbcr)) != 0:
        return None
    return y, cbcr


def yuv420_to_rgb(y: np.ndarray, cbcr: np.ndarray) -> np.ndarray | None:
    """Inverse of :func:`rgb_to_yuv420` (nearest chroma upsample)."""
    lib = _load()
    if lib is None or y.dtype != np.uint8 or cbcr.dtype != np.uint8 or y.ndim != 2:
        return None
    h, w = y.shape
    if h % 2 or w % 2 or cbcr.shape != (h // 2, w // 2, 2):
        return None
    y, cbcr = np.ascontiguousarray(y), np.ascontiguousarray(cbcr)
    rgb = np.empty((h, w, 3), np.uint8)
    if lib.cd_yuv420_to_rgb(_ptr(y), _ptr(cbcr), h, w, _ptr(rgb)) != 0:
        return None
    return rgb
