"""Convert a Caffe VGG ``.caffemodel`` into the teacher store.

The pycaffe-free replacement for the reference's dump script
(tools/convert_caffemodel_to_pth/normalise_vgg/convert_caffemodel_to_npy.py,
which needs a built Caffe just to call ``caffe.Net(...).params``): the binary
protobuf is parsed directly (``utils/caffeproto.py``) and the conv blobs are
mapped into per-stage encoder entries:

    raw VGG-19 .caffemodel
      -> cli.convert_caffe  (this tool: blobs -> original/e{k}.npz)
      -> cli.normalize_vgg  (Gatys activation normalization)
      -> WCTEngine(mode="original") / cli.prune / cli.train

Layer mapping: Caffe's ``conv1_1 .. conv5_1`` -> the specs' ``conv11 ..
conv51``; weights transposed OIHW -> HWIO. ``conv0`` (RGB->BGR x255 - mean)
is not in a raw caffemodel: the zoo's loader fills in the preprocessing
conv (``models/zoo.py:PREPROC_CONV0``), which is what Caffe's data layer
did outside the net. File formats and numpy only: no tensor goes to any
device.

    python -m collaborative_distillation_tpu_torch.cli.convert_caffe \
        --caffemodel VGG_ILSVRC_19_layers.caffemodel --out weights \
        [--stages 5 4 3 2 1] [--dump raw_blobs.npz]
"""

from __future__ import annotations

import argparse
import os
import re
import sys

import numpy as np

from ..models.specs import encoder_spec
from ..models.zoo import save_tree_npz
from ..utils.caffeproto import read_caffemodel


def caffe_to_store_name(name: str) -> str | None:
    """'conv1_1' (optionally scope-prefixed, e.g. 'vgg/conv1_1') -> 'conv11';
    None if the name is not a VGG conv layer. Suffixed names ('conv1_1_bn')
    do not match: a renamed layer is not provably the plain conv."""
    m = re.fullmatch(r".*?conv(\d)_(\d)", name)
    return f"conv{m.group(1)}{m.group(2)}" if m else None


def stage_tree(layers: dict[str, list[np.ndarray]], spec):
    """Pick this stage's convs out of the caffemodel's layers, transposed to
    the store's layout and shape-checked against the spec."""
    by_store = {}
    src_of = {}
    for lname, blobs in layers.items():
        sname = caffe_to_store_name(lname)
        if sname is not None:
            if sname in by_store:
                raise ValueError(
                    f"layers {src_of[sname]!r} and {lname!r} both map to "
                    f"{sname!r}; rename or strip the ambiguous layer")
            by_store[sname] = blobs
            src_of[sname] = lname
    tree = {}
    for lname, (wshape, bshape) in spec.param_shapes().items():
        if lname == "conv0":
            continue  # the zoo fills in the preprocessing conv
        if lname not in by_store:
            raise KeyError(f"caffemodel has no layer for {lname!r} (found: {sorted(by_store)})")
        blobs = by_store[lname]
        if len(blobs) < 2:
            raise ValueError(f"{lname}: expected weight+bias, got {len(blobs)} blobs")
        w = np.asarray(blobs[0], np.float32)
        if w.ndim != 4:
            raise ValueError(f"{lname}: weight blob is {w.shape}, want OIHW")
        w = np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # OIHW -> HWIO
        b = np.asarray(blobs[1], np.float32).reshape(-1)
        if w.shape != wshape or b.shape != bshape:
            raise ValueError(
                f"{lname}: caffemodel shapes {w.shape}/{b.shape} != spec {wshape}/{bshape}")
        tree[lname] = {"w": w, "b": b}
    return tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--caffemodel", required=True)
    ap.add_argument("--out", default="weights",
                    help="weights root; writes <out>/original/e{k}.npz")
    ap.add_argument("--stages", type=int, nargs="+", default=[5, 4, 3, 2, 1])
    ap.add_argument("--dump", default="",
                    help="also write every parametric layer's raw blobs to this flat npz "
                         "({name}_weight/{name}_bias)")
    args = ap.parse_args(argv)

    layers = read_caffemodel(args.caffemodel)
    print(f"read {len(layers)} parametric layers from {args.caffemodel}")
    if args.dump:
        flat = {}
        for name, blobs in layers.items():
            flat[f"{name}_weight"] = blobs[0]
            if len(blobs) > 1:
                flat[f"{name}_bias"] = blobs[1]
        np.savez(args.dump, **flat)
        print(f"dumped raw blobs -> {args.dump}")
    for k in args.stages:
        tree = stage_tree(layers, encoder_spec("original", k))
        path = os.path.join(args.out, "original", f"e{k}.npz")
        save_tree_npz(tree, path)
        print(f"stage {k}: {len(tree)} convs -> {path}")
    print("NOTE: raw VGG weights are unnormalized — run cli.normalize_vgg "
          "per stage to reproduce the 'vgg_normalised' teachers.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
