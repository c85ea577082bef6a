"""Image prep: center-crop to a square, and resize to an exact size.

Replaces PytorchWCT/content/{crop_center.py,resize_img.py} with one CLI,
the reference package's ``cli/imgtools.py`` without PIL:

    python -m collaborative_distillation_tpu_torch.cli.imgtools crop-center DIR
    python -m collaborative_distillation_tpu_torch.cli.imgtools resize DIR --size 3840 2160

Each ``.png``, ``.jpg`` or ``.jpeg`` in DIR (not already carrying the
suffix) is written beside itself as ``<stem><suffix><ext>``. Files are read
and written through ``utils/image.py``: PNG by the port's codec, JPEG by the
device's (nvJPEG on the card, the default; libjpeg with ``--device cpu``),
written at PIL's defaults, quality 75 with 4:2:0 chroma, as the reference
tool's ``Image.save`` writes them. ``resize`` is ``utils/image.py:resize``,
PIL's default resize bit for bit, on the host. No size cap, as the
reference tool sets ``Image.MAX_IMAGE_PIXELS = None``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..data.pipeline import is_img
from ..utils.image import decode_image, resize, save_image

PIL_JPEG_QUALITY = 75   # PIL's JpegImagePlugin default


def main(argv=None) -> int:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="the device whose JPEG codec reads and writes: cuda (default; "
                             "raises without CUDA) or cpu")
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("crop-center", parents=[common],
                       help="center-crop every image to a square")
    c.add_argument("dir")
    c.add_argument("--suffix", default="_cropped")
    r = sub.add_parser("resize", parents=[common], help="resize every image to an exact size")
    r.add_argument("dir")
    r.add_argument("--size", nargs=2, type=int, required=True, metavar=("W", "H"))
    r.add_argument("--suffix", default="_resized")
    args = ap.parse_args(argv)

    from ..wct.engine import resolve_device
    dev = resolve_device(args.device)
    for name in sorted(os.listdir(args.dir)):
        if not is_img(name) or args.suffix in name:
            continue
        path = os.path.join(args.dir, name)
        with open(path, "rb") as fh:
            img = decode_image(fh.read(), name=path, max_pixels=None, device=dev)
        h, w = img.shape[:2]
        stem, ext = os.path.splitext(path)
        if args.cmd == "crop-center":
            side = min(w, h)
            left, top = (w - side) // 2, (h - side) // 2
            out = np.ascontiguousarray(img[top:top + side, left:left + side])
        else:
            out = resize(img, *args.size)
        out_path = f"{stem}{args.suffix}{ext}"
        save_image(out, out_path, quality=PIL_JPEG_QUALITY, device=dev)
        print(f"{path} {(w, h)} -> {out_path} {(out.shape[1], out.shape[0])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
