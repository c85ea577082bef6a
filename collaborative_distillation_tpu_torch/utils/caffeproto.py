"""Minimal Caffe ``.caffemodel`` reader — no pycaffe, no protobuf library.

The port's copy of the reference package's ``utils/caffeproto.py``: numpy on
the host only, no tensor goes to any device.

Completes the reference's weight-provenance chain (SURVEY §3.5) without a
Caffe installation: the reference's dump script
(tools/convert_caffemodel_to_pth/normalise_vgg/convert_caffemodel_to_npy.py)
needs a built pycaffe (``import caffe``) just to read ``net.params`` out of
the binary file. A ``.caffemodel`` is a protobuf-serialized ``NetParameter``
message, so this module parses the protobuf *wire format* directly and
extracts the layer blobs — the only part of Caffe the chain ever used.

Supported message subset (caffe.proto):

  NetParameter:    name=1 (string), layers=2 (repeated V1LayerParameter,
                   legacy — what the VGG-19 caffemodels in the wild use),
                   layer=100 (repeated LayerParameter, modern)
  LayerParameter:  name=1 (string), type=2 (string), blobs=7
  V1LayerParameter: name=4 (string), type=5 (enum), blobs=6
  BlobProto:       data=5 (packed/unpacked float), double_data=8,
                   shape=7 (BlobShape: dim=1 repeated int64),
                   num=1 channels=2 height=3 width=4 (legacy 4-D dims);
                   diff=6 / double_diff=9 (gradients) are deliberately
                   IGNORED — a training snapshot must never have its
                   gradient arrays mistaken for weights

Everything else is skipped field-by-field (the wire format is
self-describing), so training-state junk in a snapshot does not break the
read. Unknown/hostile lengths raise ``ValueError``/``EOFError`` — never an
out-of-bounds read.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_caffemodel", "iter_fields"]

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def _varint(buf, pos: int, end: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= end:
            raise EOFError("truncated varint in caffemodel")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long in caffemodel")


def iter_fields(buf, start: int, end: int):
    """Yield ``(field_number, wire_type, value)`` over one message's span.

    ``value`` is an int for varints, and a ``(start, end)`` byte span for
    length-delimited / fixed-width fields (the caller decodes; spans avoid
    copying multi-hundred-MB weight payloads).
    """
    pos = start
    while pos < end:
        key, pos = _varint(buf, pos, end)
        field, wtype = key >> 3, key & 7
        if wtype == _WIRE_VARINT:
            val, pos = _varint(buf, pos, end)
            yield field, wtype, val
        elif wtype == _WIRE_LEN:
            n, pos = _varint(buf, pos, end)
            if n < 0 or pos + n > end:
                raise EOFError(f"field {field}: length {n} escapes message")
            yield field, wtype, (pos, pos + n)
            pos += n
        elif wtype == _WIRE_32BIT:
            if pos + 4 > end:
                raise EOFError(f"field {field}: truncated fixed32")
            yield field, wtype, (pos, pos + 4)
            pos += 4
        elif wtype == _WIRE_64BIT:
            if pos + 8 > end:
                raise EOFError(f"field {field}: truncated fixed64")
            yield field, wtype, (pos, pos + 8)
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wtype} (field {field})")


def _parse_blob(buf, start: int, end: int) -> np.ndarray:
    data_spans: list[tuple[int, int]] = []
    scalars: list[float] = []
    double_spans: list[tuple[int, int]] = []
    shape: list[int] = []
    legacy = {}
    for field, wtype, val in iter_fields(buf, start, end):
        if field == 5:  # data: packed (LEN) or unpacked (one 32BIT per elem)
            if wtype == _WIRE_LEN:
                data_spans.append(val)
            elif wtype == _WIRE_32BIT:
                scalars.append(np.frombuffer(buf[val[0]:val[1]], "<f4")[0])
            else:
                raise ValueError(
                    f"blob data field has unsupported wire type {wtype}")
        elif field == 8 and wtype == _WIRE_LEN:  # double_data, packed
            double_spans.append(val)
        elif field == 7 and wtype == _WIRE_LEN:  # BlobShape
            for f2, w2, v2 in iter_fields(buf, val[0], val[1]):
                if f2 == 1:
                    if w2 == _WIRE_VARINT:
                        shape.append(v2)
                    else:  # packed dims
                        p = v2[0]
                        while p < v2[1]:
                            d, p = _varint(buf, p, v2[1])
                            shape.append(d)
        elif field in (1, 2, 3, 4) and wtype == _WIRE_VARINT:
            legacy[field] = val
    if double_spans:
        arr = np.concatenate([
            np.frombuffer(buf[a:b], "<f8") for a, b in double_spans
        ]).astype(np.float32)
    elif data_spans:
        arr = np.concatenate([np.frombuffer(buf[a:b], "<f4")
                              for a, b in data_spans])
    else:
        arr = np.asarray(scalars, np.float32)
    if not shape and legacy:
        shape = [legacy.get(i, 1) for i in (1, 2, 3, 4)]  # num,ch,h,w
        if shape[:3] == [1, 1, 1]:  # biases: (1,1,1,C) -> (C,); a genuine
            shape = shape[3:]       # num=1 conv (1,C,kh,kw) stays 4-D
    if shape:
        if int(np.prod(shape)) != arr.size:
            raise ValueError(
                f"blob claims shape {shape} but carries {arr.size} elements")
        arr = arr.reshape(shape)
    return arr


def _parse_layer(buf, start: int, end: int, *, legacy: bool):
    name_f, blobs_f = (4, 6) if legacy else (1, 7)
    name = ""
    blobs: list[np.ndarray] = []
    for field, wtype, val in iter_fields(buf, start, end):
        if field == name_f and wtype == _WIRE_LEN:
            name = bytes(buf[val[0]:val[1]]).decode("utf-8", errors="replace")
        elif field == blobs_f and wtype == _WIRE_LEN:
            blobs.append(_parse_blob(buf, val[0], val[1]))
    return name, blobs


def read_caffemodel(path: str) -> dict[str, list[np.ndarray]]:
    """``.caffemodel`` -> ``{layer_name: [blob arrays]}`` for every layer
    that carries parameters (conv/fc: ``[weight OIHW, bias]``). Layer order
    is preserved (dict insertion order = file order)."""
    with open(path, "rb") as fh:
        buf = memoryview(fh.read())
    out: dict[str, list[np.ndarray]] = {}
    for field, wtype, val in iter_fields(buf, 0, len(buf)):
        if wtype != _WIRE_LEN or field not in (2, 100):
            continue
        name, blobs = _parse_layer(buf, val[0], val[1], legacy=field == 2)
        if blobs:
            out[name] = blobs
    return out
