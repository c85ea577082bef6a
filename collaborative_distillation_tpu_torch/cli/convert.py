"""Convert the reference's checkpoints into the weight store.

    python -m collaborative_distillation_tpu_torch.cli.convert \
        --reference trained_models --out weights

Walks a directory laid out as the reference's ``trained_models/`` and
writes ``<out>/<mode>/{e,d}{k}.npz``, the store the zoo reads: the 16x
students (``.pth``), the kd2sd decoders, the pruned-init bases and the
teacher autoencoders (``.t7``, or the ``our_BD`` ``.pth`` decoders where no
``.t7`` decoder is there). It converts whatever it finds and prints a
``[missing]`` line for each file that is not there (the teachers and
``our_BD`` are external downloads in the reference too, README.md:26/62).
``.pth`` files load with ``weights_only=True`` (``utils/torch_convert.py``).
File formats and numpy only: no tensor goes to any device.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..models.zoo import save_tree_npz
from ..utils.torch_convert import (T7_DECODER_LAYER_INDEX, T7_ENCODER_LAYER_INDEX, convert_pth,
                                   convert_t7_sequential)


def _convert(src: str, dst: str, kind: str, stage: int) -> bool:
    if not os.path.exists(src):
        print(f"  [missing] {src}")
        return False
    if src.endswith(".t7"):
        index = (T7_ENCODER_LAYER_INDEX if kind == "e" else T7_DECODER_LAYER_INDEX)[stage]
        tree = convert_t7_sequential(src, index)
    else:
        tree = convert_pth(src)
    save_tree_npz(tree, dst)
    n = sum(v["w"].size + v["b"].size for v in tree.values())
    print(f"  {src} -> {dst} ({len(tree)} layers, {n:,} params)")
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reference", default="trained_models",
                    help="the reference's trained_models directory")
    ap.add_argument("--out", default="weights", help="output weight store root")
    args = ap.parse_args(argv)
    ref, out = args.reference, args.out

    print("== 16x trained students (wct_se_16x_new / wct_se_16x_new_sd)")
    for k in range(1, 6):
        _convert(os.path.join(ref, "wct_se_16x_new", f"{k}SE.pth"),
                 os.path.join(out, "16x", f"e{k}.npz"), "e", k)
        _convert(os.path.join(ref, "wct_se_16x_new_sd", f"{k}SD.pth"),
                 os.path.join(out, "16x", f"d{k}.npz"), "d", k)

    print("== 16x kd2sd decoders")
    for k in range(1, 6):
        _convert(os.path.join(ref, "wct_se_16x_new_sd_kd2sd", f"{k}SD.pth"),
                 os.path.join(out, "16x_kd2sd", f"d{k}.npz"), "d", k)

    print("== 16x pruned-init bases (small16x_ae_base)")
    for k in range(1, 6):
        _convert(os.path.join(ref, "small16x_ae_base", f"e{k}_base.pth"),
                 os.path.join(out, "16x_base", f"e{k}.npz"), "e", k)
        _convert(os.path.join(ref, "small16x_ae_base", f"d{k}_base.pth"),
                 os.path.join(out, "16x_base", f"d{k}.npz"), "d", k)

    print("== original teacher autoencoders (t7 / our_BD)")
    for k in range(1, 6):
        _convert(os.path.join(ref, "original_wct_models", f"vgg_normalised_conv{k}_1.t7"),
                 os.path.join(out, "original", f"e{k}.npz"), "e", k)
        dec_t7 = os.path.join(ref, "original_wct_models", f"feature_invertor_conv{k}_1.t7")
        dec_bd = os.path.join(ref, "our_BD", f"{k}BD_E30S0.pth")
        _convert(dec_t7 if os.path.exists(dec_t7) else dec_bd,
                 os.path.join(out, "original", f"d{k}.npz"), "d", k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
