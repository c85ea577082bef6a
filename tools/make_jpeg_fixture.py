#!/usr/bin/env python3
"""Write ``collaborative_distillation_tpu_torch/data/jpeg_fixture.npz``: JPEG
files and libjpeg's decodes of them, for holding nvJPEG on the card against
libjpeg without libjpeg there.

Made with the reference package's libjpeg binding
(``collaborative_distillation_tpu/data/native_codec.py``, built from
``native/imgcodec.cpp``) and PIL, from the repository's own images:

* ``in1_jpeg``: the bytes of ``docs/examples/in1+in1_16x.jpg`` (512^2,
  baseline 4:2:0), with libjpeg's planes ``in1_y``, ``in1_cbcr``
  (``decode_jpeg_yuv420``) and RGB ``in1_rgb`` (``decode_jpeg``);
* ``c444_jpeg``, ``prog_jpeg``: the photo pair's content, a 256^2 crop,
  written by PIL at quality 95 as 4:4:4 and as progressive 4:2:0, with
  libjpeg's RGB ``c444_rgb``, ``prog_rgb`` (no planes: neither is a
  baseline 4:2:0 file);
* ``odd_jpeg``: a 125 x 127 crop, baseline 4:2:0 by libjpeg at quality 90,
  and ``grey_jpeg``: a 128^2 crop's red channel by PIL (one component),
  with libjpeg's RGB ``odd_rgb``, ``grey_rgb``;
* ``content_y``, ``content_cbcr``: the photo pair's 512^2 content as 4:2:0
  planes (``rgb_to_yuv420``), and ``content_q95``: libjpeg's quality-95
  encode of those planes (``encode_jpeg_yuv420``).

Byte strings are stored as uint8 arrays. Run from the repository root:

    python3 tools/make_jpeg_fixture.py
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

OUT = os.path.join(HERE, "collaborative_distillation_tpu_torch", "data", "jpeg_fixture.npz")


def _pil(img: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def main() -> int:
    if not nc.available():
        print("the reference codec did not build: libjpeg and g++ are needed", file=sys.stderr)
        return 1
    with np.load(os.path.join(HERE, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        content = d["content"]
    with open(os.path.join(HERE, "docs", "examples", "in1+in1_16x.jpg"), "rb") as f:
        in1 = f.read()
    crop = np.ascontiguousarray(content[128:384, 128:384])
    files = {"in1": in1,
             "c444": _pil(crop, quality=95, subsampling=0),
             "prog": _pil(crop, quality=95, progressive=True),
             "odd": nc.encode_jpeg(np.ascontiguousarray(content[:125, :127]), quality=90),
             "grey": _pil(np.ascontiguousarray(crop[:128, :128, 0]), quality=95)}
    out = {}
    for name, data in files.items():
        out[f"{name}_jpeg"] = np.frombuffer(data, np.uint8)
        out[f"{name}_rgb"] = nc.decode_jpeg(data)
    out["in1_y"], out["in1_cbcr"] = nc.decode_jpeg_yuv420(in1)
    y, cbcr = nc.rgb_to_yuv420(content)
    out.update(content_y=y, content_cbcr=cbcr,
               content_q95=np.frombuffer(nc.encode_jpeg_yuv420(y, cbcr, quality=95), np.uint8))
    np.savez_compressed(OUT, **out)
    print(f"{OUT}: {os.path.getsize(OUT)} bytes, " + ", ".join(
        f"{k} {v.shape}" for k, v in out.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
