#!/usr/bin/env python3
"""Write ``collaborative_distillation_tpu_torch/data/jpeg_train_fixture.npz``:
JPEG files and the reference's shorter-side decodes of them, for holding the
card's training decode (nvJPEG's whole decode, then the kernels of
``ops/cuda/resize.py``) against the reference without libjpeg on the card.

Made with the reference package's libjpeg binding
(``collaborative_distillation_tpu/data/native_codec.py``, built from
``native/imgcodec.cpp``) and PIL, from crops of the photo pair reflect-tiled
to size (``data/photo_pair_512.npz``). For each file ``NAME``: ``NAME_jpeg``
(the bytes), ``NAME_side`` (the shorter side it is read at) and
``NAME_out``, the reference's ``decode_jpeg_shorter_side(NAME_jpeg,
NAME_side)``. The files (H x W, the scale ``denom`` the reference picks):

* ``d1``, ``d2``, ``d4``, ``d8``: baseline 4:2:0 at quality 95 by libjpeg
  at shorter side 40, ``denom`` 1, 2, 4 and 8 (61 x 83, 130 x 171,
  233 x 171 portrait, 331 x 450; no size a multiple of its ``denom``);
* ``c444``: 4:4:4 by PIL at quality 95, 141 x 190, ``denom`` 2;
* ``prog``: progressive 4:2:0 by PIL at quality 95, 181 x 247, ``denom`` 4;
* ``up``: 33 x 47 at shorter side 40, an upscale (``denom`` 1, every box
  window one pixel);
* ``coco``: 480 x 640 at shorter side 300, COCO's usual size (``denom`` 1).

Byte strings are stored as uint8 arrays. Run from the repository root:

    python3 tools/make_jpeg_train_fixture.py
"""

from __future__ import annotations

import io
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from collaborative_distillation_tpu.data import native_codec as nc  # noqa: E402

OUT = os.path.join(HERE, "collaborative_distillation_tpu_torch", "data",
                   "jpeg_train_fixture.npz")
# name: (image, h, w, shorter side, writer)
FILES = {"d1": ("content", 61, 83, 40, "libjpeg"), "d2": ("style", 130, 171, 40, "libjpeg"),
         "d4": ("content", 233, 171, 40, "libjpeg"), "d8": ("style", 331, 450, 40, "libjpeg"),
         "c444": ("content", 141, 190, 40, "pil444"), "prog": ("style", 181, 247, 40, "pilprog"),
         "up": ("content", 33, 47, 40, "libjpeg"), "coco": ("content", 480, 640, 300, "libjpeg")}


def tile(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``img`` reflect-tiled to (h, w)."""
    while img.shape[0] < h or img.shape[1] < w:
        img = np.pad(img, ((0, min(img.shape[0] - 1, max(0, h - img.shape[0]))),
                           (0, min(img.shape[1] - 1, max(0, w - img.shape[1]))), (0, 0)),
                     mode="reflect")
    return np.ascontiguousarray(img[:h, :w])


def encode(img: np.ndarray, writer: str) -> bytes:
    if writer == "libjpeg":
        return nc.encode_jpeg(img, quality=95)
    buf = io.BytesIO()
    kw = {"subsampling": 0} if writer == "pil444" else {"progressive": True}
    Image.fromarray(img).save(buf, "JPEG", quality=95, **kw)
    return buf.getvalue()


def main() -> int:
    if not nc.available():
        print("the reference codec did not build: libjpeg and g++ are needed", file=sys.stderr)
        return 1
    with np.load(os.path.join(HERE, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        photos = {k: d[k] for k in ("content", "style")}
    out = {}
    for name, (src, h, w, side, writer) in FILES.items():
        data = encode(tile(photos[src], h, w), writer)
        out[f"{name}_jpeg"] = np.frombuffer(data, np.uint8)
        out[f"{name}_side"] = np.int64(side)
        out[f"{name}_out"] = nc.decode_jpeg_shorter_side(data, side)
    np.savez_compressed(OUT, **out)
    print(f"{OUT}: {os.path.getsize(OUT)} bytes, " + ", ".join(
        f"{k} {v.shape}" for k, v in out.items() if k.endswith("_out")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
