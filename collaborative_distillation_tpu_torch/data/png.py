"""PNG files read and written with ``zlib`` and numpy.

:func:`decode_png` reads 8-bit greyscale, greyscale with alpha, RGB, RGBA
and palette images that are not interlaced, and returns them as RGB (alpha
dropped, palette looked up), as ``PIL.Image.convert("RGB")`` does. Anything
else raises and names what it is. Rows filtered with None, Sub or Up are
reversed with whole-array numpy operations; Average and Paeth, which PNG
writers choose for photos, are sequential along a row and are reversed by
``csrc/png_unfilter.c``, built with ``g++`` at first use into
``build/torch_kernels/png-<source hash>/`` at the repository root. Where
that build cannot run, reading such a file raises with the compiler's
reason: no Python loop stands in.

:func:`encode_png` writes RGB with the Up filter on every row (one
whole-array subtraction).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["PNG_SIGNATURE", "decode_png", "encode_png", "build_dir"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "png_unfilter.c")
_CMD = ["g++", "-O3", "-fPIC", "-shared"]
# (argtypes, restype) of the C entry point
_SIGNATURES = {"cd_png_unfilter": ([ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                                    ctypes.c_int, ctypes.c_void_p], ctypes.c_int)}
# zlib level of the port's PNGs: a UHD image writes in about half the time
# it takes at level 6 (PIL's default), for a few percent more bytes
_LEVEL = 1
# bytes deflated by one thread: a 2048^2 RGB image splits over six
_PIECE = 2 << 20
# colour type -> (channels, name)
_COLOR_TYPES = {0: (1, "greyscale"), 2: (3, "RGB"), 3: (1, "palette"),
                4: (2, "greyscale with alpha"), 6: (4, "RGBA")}

_lock = threading.Lock()
_lib = None
_reason: str | None = None   # why the helper is unavailable, once it was tried


def build_dir() -> str:
    """``build/torch_kernels/png-<hash of the source and flags>``."""
    h = hashlib.sha256(" ".join(_CMD).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_REPO, "build", "torch_kernels", "png-" + h.hexdigest()[:16])


def _build() -> str:
    out_dir = build_dir()
    so = os.path.join(out_dir, "libpngunfilter.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            r = subprocess.run([*_CMD, "-o", tmp, _SRC], capture_output=True, text=True,
                               timeout=120)
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
            _reason = f"PNG filter helper unavailable: {e}"
    return _lib


def _chunks(data: bytes):
    """(type, payload) of every chunk, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    view = memoryview(data)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", view[pos:pos + 8])
        if pos + 12 + n > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        body = view[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", view[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(body, zlib.crc32(kind)) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered rows -> (h, stride) bytes."""
    ft = raw[:, 0]
    f = raw[:, 1:]
    if ft.max(initial=0) > 4:
        raise ValueError(f"PNG row {int(np.argmax(ft > 4))} has filter type {int(ft.max())}")
    if (ft > 2).any():   # Average or Paeth: the C helper does every row
        lib = _load()
        if lib is None:
            raise RuntimeError(f"cannot reverse the PNG's Average/Paeth filters: {_reason}")
        src = np.ascontiguousarray(raw)
        out = np.empty((h, stride), np.uint8)
        rc = lib.cd_png_unfilter(src.ctypes.data_as(ctypes.c_void_p), h, stride, bpp,
                                 out.ctypes.data_as(ctypes.c_void_p))
        if rc:
            raise ValueError(f"PNG row {-1 - rc} has a bad filter type")
        return out
    if (ft == 1).all():
        return _sub(f, bpp)
    # None, Sub and Up rows, one whole-row operation each (a cumulative sum
    # down the columns is 20x slower than this loop at 4096 x 30720)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        if ft[r] == 1:
            out[r] = _sub(f[r:r + 1], bpp)[0]
        elif ft[r] == 2:
            np.add(f[r], prev, out=out[r])
        else:
            out[r] = f[r]
        prev = out[r]
    return out


def _sub(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Reverse Sub: a running sum (mod 256) of each byte lane along the row."""
    n, stride = rows.shape
    return np.cumsum(rows.reshape(n, stride // bpp, bpp), axis=1,
                     dtype=np.uint8).reshape(n, stride)


def decode_png(data: bytes, *, max_pixels: int | None = None) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB. Raises ValueError for anything that
    is not an 8-bit, non-interlaced greyscale, greyscale+alpha, RGB, RGBA or
    palette PNG, or whose size exceeds ``max_pixels``."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"PNG IHDR of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _COLOR_TYPES:
        raise ValueError(f"PNG colour type {ctype} is not a valid one")
    channels, cname = _COLOR_TYPES[ctype]
    if depth != 8:
        raise ValueError(f"{depth}-bit {cname} PNG is not supported (8-bit only)")
    if interlace:
        raise ValueError(f"interlaced (Adam7) {cname} PNG is not supported")
    if w == 0 or h == 0:
        raise ValueError(f"PNG of {w}x{h} pixels")
    if max_pixels is not None and w * h > max_pixels:
        raise ValueError(f"PNG of {w}x{h} pixels is over the {max_pixels}-pixel limit")
    stride = w * channels
    size = h * (stride + 1)
    dec = zlib.decompressobj()
    raw = dec.decompress(idat[0] if len(idat) == 1 else b"".join(idat), size)
    if len(raw) != size:
        raise ValueError(f"PNG image data holds {len(raw)} bytes, {size} expected")
    px = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, stride + 1), h, stride,
                   channels).reshape(h, w, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if channels <= 2:   # greyscale (+ alpha)
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _deflate(buf: np.ndarray) -> bytes:
    """One zlib stream of ``buf``; over ``_PIECE`` bytes the pieces are
    deflated in parallel threads (zlib releases the GIL) and joined as pigz
    does: each piece but the last ends on a byte boundary (a sync flush),
    and one Adler-32 of the whole closes the stream."""
    flat = buf.reshape(-1)
    if flat.size <= _PIECE:
        return zlib.compress(flat, _LEVEL)

    def deflate(a: int) -> bytes:
        c = zlib.compressobj(_LEVEL, zlib.DEFLATED, -15)
        last = a + _PIECE >= flat.size
        return c.compress(flat[a:a + _PIECE]) + c.flush(zlib.Z_FINISH if last
                                                        else zlib.Z_SYNC_FLUSH)

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        body = b"".join(pool.map(deflate, range(0, flat.size, _PIECE)))
    return b"\x78\x01" + body + struct.pack(">I", zlib.adler32(flat))


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes: 8-bit RGB, the Up filter on every row,
    one IDAT chunk."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 or not rgb.size:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.ascontiguousarray(rgb).reshape(h, w * 3)
    filtered = np.empty((h, w * 3 + 1), np.uint8)
    filtered[:, 0] = 2
    filtered[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=filtered[1:, 1:])
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", _deflate(filtered))
            + _chunk(b"IEND", b""))
