"""Export a trained student from a trainer checkpoint into the weight store.

A trainer checkpoint is one npz holding the params (``params/<layer>/<w|b>``),
the optimizer state and a ``meta/`` tree; this tool writes just the params as
a weight-store stage file (``16x/d{k}.npz`` layout, ``models/zoo.py``) that
the stylize and eval CLIs load. It reads the checkpoint format of the
reference package's trainer unchanged, and needs only numpy.

    python -m collaborative_distillation_tpu_torch.cli.export \\
        Experiments/<run>/weights/<ckpt>.npz --out weights/16x/d1.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def export_student(ckpt_path: str, out_path: str) -> dict:
    """Extract ``params/`` leaves from a trainer checkpoint into a stage npz.

    Returns the checkpoint's meta dict (mode/stage/epoch/step) for logging.
    """
    if not ckpt_path.endswith(".npz"):
        ckpt_path += ".npz"
    with np.load(ckpt_path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    params = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    if not params:
        raise SystemExit(f"{ckpt_path} has no 'params/' leaves — not a "
                         f"trainer checkpoint (keys: {sorted(flat)[:5]}...)")
    meta = {}
    for k, v in flat.items():
        if k.startswith("meta/"):
            name = k[len("meta/"):]
            if name.endswith("__json__"):
                meta[name[:-len("/__json__")].rstrip("/")] = json.loads(str(v[0]))
            else:
                meta[name] = v.item() if v.ndim == 0 else v
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **params)
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ckpt", help="trainer checkpoint (.npz)")
    ap.add_argument("--out", required=True,
                    help="weight-store stage file to write, e.g. weights/16x/d1.npz")
    args = ap.parse_args(argv)
    meta = export_student(args.ckpt, args.out)
    print(f"exported student params -> {args.out}  (ckpt meta: {meta})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
