"""Convert a stock MobileNetV1 classifier checkpoint into the five truncated
WCT encoder .npz files.

The working equivalent of the reference's dead
``tools/convert_original_mobilenet_to_mine.py`` (its ``model_MobileNet``
import was never committed upstream). The same surface: one positional
checkpoint path, five outputs named ``<stem>_my_e{k}.npz``
(convert_original_mobilenet_to_mine.py:52,70), each a param tree with
BatchNorm folded into the convs (``models/mobilenet.py``), for
``apply_mobilenet_encoder``. The checkpoint loads with ``weights_only=True``
(``utils/torch_convert.py:load_pth``). File formats and numpy only: no
tensor goes to any device.

    python -m collaborative_distillation_tpu_torch.cli.convert_mobilenet \
        mobilenet_sgd.pth [--out-dir weights/mobilenet]
"""

from __future__ import annotations

import argparse
import os

from ..models.mobilenet import convert_mobilenet_state_dict, mobilenet_layer_table
from ..models.zoo import save_tree_npz
from ..utils.torch_convert import load_pth


def load_state_dict(path: str):
    """The checkpoint's state dict: ``{"state_dict": sd}`` wrapping (the
    reference's input format, convert_original_mobilenet_to_mine.py:53) or a
    bare state dict."""
    obj = load_pth(path)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", help="stock MobileNetV1 .pth (torch)")
    ap.add_argument("--out-dir", default=None,
                    help="output directory (default: alongside the checkpoint)")
    ap.add_argument("--eps", type=float, default=1e-5,
                    help="BatchNorm eps used when folding (torch default 1e-5)")
    args = ap.parse_args(argv)

    sd = load_state_dict(args.checkpoint)
    stem = os.path.splitext(os.path.basename(args.checkpoint))[0]
    out_dir = args.out_dir or (os.path.dirname(args.checkpoint) or ".")
    for stage in range(1, 6):
        print(f"=====> processing encoder {stage}")
        tree = convert_mobilenet_state_dict(sd, stage, eps=args.eps)
        dst = os.path.join(out_dir, f"{stem}_my_e{stage}.npz")
        save_tree_npz(tree, dst)
        names = [l["name"] for l in mobilenet_layer_table(stage)]
        n = sum(v["w"].size + v["b"].size for v in tree.values())
        print(f"  {dst}: {len(names)} folded convs ({names[0]}..{names[-1]}), {n:,} params")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
