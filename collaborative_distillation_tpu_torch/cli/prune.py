"""L1 filter pruning: a teacher stage's weights -> a student's initial weights.

The CLI of the reference's tools/prune.py (which produced
``trained_models/small16x_ae_base``), over the weight store:

    python -m collaborative_distillation_tpu_torch.cli.prune \
        --teacher weights/original/e5.npz --kind encoder --stage 5 \
        --output weights/16x_base/e5.npz

The pruned layers are ``train/prune.py:prune_to_student``'s, the reference
package's bit for bit. The encoder's aux adapters have no teacher
counterpart: they are drawn by ``init_params`` from a ``torch.Generator``
seeded with ``--aux_seed``, so they are not the reference tool's
``jax.random`` values. numpy on the host: no tensor goes to any device.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..models.specs import decoder_spec, encoder_spec
from ..models.vgg import init_params
from ..models.zoo import load_stage_params, save_tree_npz
from ..train.prune import prune_to_student


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--teacher", required=True, help="teacher stage weights (.npz)")
    ap.add_argument("--kind", choices=["encoder", "decoder"], required=True)
    ap.add_argument("--stage", type=int, required=True, choices=[1, 2, 3, 4, 5])
    ap.add_argument("--output", required=True)
    ap.add_argument("--aux_seed", type=int, default=0,
                    help="seed for the (teacher-less) aux adapter init")
    args = ap.parse_args(argv)

    if args.kind == "encoder":
        t_spec = encoder_spec("original", args.stage)
        s_spec = encoder_spec("16x", args.stage, aux=True)
    else:
        t_spec = decoder_spec("original", args.stage)
        s_spec = decoder_spec("16x", args.stage)
    teacher = load_stage_params(args.teacher, t_spec)
    aux = init_params(s_spec, torch.Generator().manual_seed(args.aux_seed))
    student = prune_to_student(teacher, s_spec, init_aux=aux)
    save_tree_npz(student, args.output)
    n = sum(v["w"].size + v["b"].size for v in student.values())
    print(f"pruned {args.teacher} -> {args.output} ({len(student)} layers, {n:,} params)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
