"""JPEG headers in pure Python: what a file is, before any codec opens it.

:func:`parse` reads the markers from SOI up to the first SOS: the frame
(SOF0-SOF15: size, components and their sampling factors, baseline or
progressive), the quantization tables (DQT), the restart interval (DRI) and
the JFIF and Adobe markers that decide the colour space the way libjpeg's
``default_decompress_parms`` does. It returns None where libjpeg's
``jpeg_read_header`` would fail: no SOI, a segment cut short, no frame
before the first scan, a size of 0 or over 65500, samples of other than 8
bits, sampling factors outside 1..4, a scan naming no frame component.

The servers and engines ask it before they decode: the decompression-bomb
cap, the choice between the 4:2:0 planes path and the whole-image RGB path,
and the ``transport="auto"`` cut all need the header alone, on a machine
whose codec may be the card's.

:func:`ijg_quant_tables` gives the tables that libjpeg's
``jpeg_set_quality(quality, force_baseline=TRUE)`` writes: the JPEG
standard's (Annex K) scaled by the IJG quality formula.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Component", "JpegHeader", "parse", "jpeg_dims", "ijg_quant_tables", "ZIGZAG"]

# natural (row-major) index of each zigzag position of an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# JPEG standard, Annex K.1 and K.2, in natural order (libjpeg's jcparam.c)
_STD_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMINANCE = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99])

# start-of-frame markers (0xC4 DHT, 0xC8 JPG and 0xCC DAC are not frames)
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}
_PROGRESSIVE = {0xC2, 0xC6, 0xCA, 0xCE}
_STANDALONE = {0x01, *range(0xD0, 0xD8)}   # TEM and RST0-7 carry no length
_MAX_DIM = 65500                             # libjpeg's JPEG_MAX_DIMENSION


@dataclass(frozen=True)
class Component:
    id: int
    h: int    # horizontal sampling factor
    v: int    # vertical sampling factor
    tq: int   # quantization table selector


@dataclass(frozen=True)
class JpegHeader:
    width: int
    height: int
    sof: int                       # the frame marker, 0xC0 baseline ... 0xCF
    components: tuple[Component, ...]
    quant_tables: dict = field(default_factory=dict)   # {Tq: (8, 8) uint16, natural order}
    restart_interval: int = 0
    jfif: bool = False
    adobe_transform: int | None = None

    @property
    def progressive(self) -> bool:
        return self.sof in _PROGRESSIVE

    @property
    def sequential_huffman(self) -> bool:
        """Baseline (SOF0) or extended sequential (SOF1), Huffman-coded:
        what libjpeg's raw-data reader streams without buffering scans."""
        return self.sof in (0xC0, 0xC1)

    @property
    def color_space(self) -> str:
        """``"grey"``, ``"ycbcr"``, ``"rgb"``, ``"cmyk"`` or ``"ycck"``, as
        libjpeg guesses it from the markers and the component ids."""
        n = len(self.components)
        if n == 1:
            return "grey"
        if n == 3:
            if self.jfif:
                return "ycbcr"
            if self.adobe_transform is not None:
                return "rgb" if self.adobe_transform == 0 else "ycbcr"
            ids = tuple(c.id for c in self.components)
            return "rgb" if ids == (82, 71, 66) else "ycbcr"   # 'R', 'G', 'B'
        if n == 4:
            return "ycck" if self.adobe_transform == 2 else "cmyk"
        return "unknown"

    @property
    def sampling(self) -> tuple[tuple[int, int], ...]:
        return tuple((c.h, c.v) for c in self.components)

    @property
    def is_yuv420(self) -> bool:
        """A sequential YCbCr file with 2x2 luma and 1x1 chroma sampling:
        the files whose 4:2:0 planes are read straight out (libjpeg's
        ``cd_jpeg_decode_yuv420`` test)."""
        return (self.sequential_huffman and self.color_space == "ycbcr"
                and self.sampling == ((2, 2), (1, 1), (1, 1)))

    @property
    def planes_ok(self) -> bool:
        """The planes path takes it: 4:2:0 at an even height and width."""
        return self.is_yuv420 and self.width % 2 == 0 and self.height % 2 == 0


def _segments(data: bytes):
    """(marker, payload) of each segment after SOI, up to and including the
    first SOS; raises ValueError where the data ends or is not markers."""
    if len(data) < 2 or data[0] != 0xFF or data[1] != 0xD8:
        raise ValueError("no SOI")
    i = 2
    while True:
        if i >= len(data) or data[i] != 0xFF:
            raise ValueError(f"no marker at byte {i}")
        while i < len(data) and data[i] == 0xFF:   # fill bytes
            i += 1
        if i >= len(data):
            raise ValueError("the data ends in fill bytes")
        marker = data[i]
        i += 1
        if marker in _STANDALONE:
            continue
        if marker in (0xD8, 0xD9):
            raise ValueError(f"marker 0x{marker:02X} before the first scan")
        if i + 2 > len(data):
            raise ValueError("a segment length is cut short")
        n = struct.unpack(">H", data[i:i + 2])[0]
        if n < 2 or i + n > len(data):
            raise ValueError(f"segment 0x{marker:02X} of {n} bytes is cut short")
        yield marker, data[i + 2:i + n]
        if marker == 0xDA:
            return
        i += n


def _quant_tables(payload: bytes, tables: dict) -> None:
    i = 0
    while i < len(payload):
        pq, tq = payload[i] >> 4, payload[i] & 15
        size = 64 * (pq + 1)
        if pq > 1 or tq > 3 or i + 1 + size > len(payload):
            raise ValueError("bad DQT")
        vals = np.frombuffer(payload[i + 1:i + 1 + size], ">u2" if pq else "u1")
        natural = np.empty(64, np.uint16)
        natural[ZIGZAG] = vals
        tables[tq] = natural.reshape(8, 8)
        i += 1 + size


def _frame(marker: int, payload: bytes) -> dict:
    if len(payload) < 6:
        raise ValueError("SOF cut short")
    precision, height, width, n = struct.unpack(">BHHB", payload[:6])
    if len(payload) != 6 + 3 * n or not 1 <= n <= 10:
        raise ValueError("bad SOF length")
    if not (0 < height <= _MAX_DIM and 0 < width <= _MAX_DIM):
        raise ValueError("an image size of 0 (DNL is not supported) or over 65500")
    if precision != 8:
        raise ValueError(f"{precision}-bit samples")
    comps = []
    for k in range(n):
        cid, hv, tq = payload[6 + 3 * k:9 + 3 * k]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise ValueError("bad sampling factors")
        comps.append(Component(cid, h, v, tq))
    return dict(sof=marker, height=height, width=width,
                components=tuple(comps))


def parse(data: bytes) -> JpegHeader | None:
    """The header of JPEG ``data`` (see the module), or None where it is
    not one libjpeg would read."""
    tables: dict = {}
    frame, restart, jfif, adobe = None, 0, False, None
    try:
        for marker, payload in _segments(data):
            if marker in _SOF:
                if frame is not None:
                    raise ValueError("two frames")
                frame = _frame(marker, payload)
            elif marker == 0xDB:
                _quant_tables(payload, tables)
            elif marker == 0xDD:
                if len(payload) != 2:
                    raise ValueError("bad DRI")
                restart = struct.unpack(">H", payload)[0]
            elif marker == 0xE0 and payload[:5] == b"JFIF\0":
                jfif = True
            elif marker == 0xEE and payload[:5] == b"Adobe" and len(payload) >= 12:
                adobe = payload[11]
            elif marker == 0xDA:
                if frame is None:
                    raise ValueError("a scan before the frame")
                if not payload or len(payload) != 4 + 2 * payload[0] or payload[0] < 1:
                    raise ValueError("bad SOS")
                ids = {c.id for c in frame["components"]}
                if any(payload[1 + 2 * k] not in ids for k in range(payload[0])):
                    raise ValueError("a scan names a component the frame lacks")
                return JpegHeader(quant_tables=tables, restart_interval=restart, jfif=jfif,
                                  adobe_transform=adobe, **frame)
    except ValueError:
        return None
    return None


def jpeg_dims(data: bytes) -> tuple[int, int] | None:
    """(width, height) from the header alone; None where it is bad."""
    hdr = parse(data)
    return None if hdr is None else (hdr.width, hdr.height)


def ijg_quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """(luminance, chrominance) (8, 8) uint16 tables in natural order, as
    ``jpeg_set_quality(quality, force_baseline=TRUE)`` sets them: quality
    clamped to 1..100, scale 5000/q below 50 and 200 - 2q from there,
    entries (t * scale + 50) // 100 clamped to 1..255."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255).astype(np.uint16).reshape(8, 8)
                 for t in (_STD_LUMINANCE, _STD_CHROMINANCE))
