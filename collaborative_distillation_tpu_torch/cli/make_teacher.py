"""Build a synthetic *normalized* teacher weight store (no downloads).

The real teacher autoencoders (``vgg_normalised_conv{k}_1.t7``, ``our_BD``)
are external downloads in the reference checkout too, so a fresh clone
cannot run ``--mode original`` or the distillation trainer without them.
This tool writes a store that exercises the whole teacher-dependent path:

* encoders: Kaiming-uniform random VGG-19 stage weights with the reference's
  baked-in preprocessing conv0 (RGB->BGR x255 - ImageNet mean,
  model_original.py:428-433), passed through the Gatys activation
  normalization the real teachers received (:mod:`.normalize_vgg`: mean
  filter activation 1 over a calibration set), so WCT covariances are well
  scaled and the distillation losses numerically realistic;
* decoders: Kaiming-uniform random mirrors (the reference's ``our_BD``
  decoders were trained offline with an unpublished recipe; a synthetic
  store reproduces only their shapes and scale).

It writes ``<out>/original/e{k}.npz`` and ``d{k}.npz``, which the zoo, the
trainer and ``WCTEngine(mode="original")`` read. The weights are drawn from
a ``torch.Generator`` seeded with ``--seed`` (the port's ``init_params``),
so the store is not the reference tool's byte for byte: ``jax.random`` is
not reproduced. The calibration images are the reference's, the same
arrays for the same seed. The normalization runs on ``--device`` (the card
unless ``--device cpu``).

    python -m collaborative_distillation_tpu_torch.cli.make_teacher \
        --out weights --stages 1 2 3 4 5 [--images <calib dir>] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def synth_calibration_batches(n_images: int, batch: int, size: int, seed: int):
    """Smooth random calibration images in [0, 1], float32 (N, size, size,
    3) batches: low-frequency blobs, closer to natural-image statistics than
    noise, which drives ReLU activations into uniform regimes."""
    rng = np.random.default_rng(seed)
    batches = []
    for i in range(0, n_images, batch):
        n = min(batch, n_images - i)
        small = rng.random((n, size // 16, size // 16, 3), np.float32)
        up = small.repeat(16, axis=1).repeat(16, axis=2)
        # separable box blur to soften the block edges
        k = 9
        pad = np.pad(up, ((0, 0), (k // 2, k // 2), (0, 0), (0, 0)), mode="edge")
        up = np.stack([pad[:, j:j + up.shape[1]] for j in range(k)]).mean(0)
        pad = np.pad(up, ((0, 0), (0, 0), (k // 2, k // 2), (0, 0)), mode="edge")
        up = np.stack([pad[:, :, j:j + up.shape[2]] for j in range(k)]).mean(0)
        batches.append(up.astype(np.float32))
    return batches


def build_synthetic_teacher(out_root: str, stages=(1, 2, 3, 4, 5), *, seed: int = 0,
                            calib_batches=None, n_images: int = 16, batch: int = 4,
                            size: int = 128, device=None, log=print) -> None:
    """Write the teacher store's encoders and decoders for ``stages`` under
    ``out_root/original``; ``device`` runs the normalization (None: the card)."""
    from ..models.specs import decoder_spec, encoder_spec
    from ..models.vgg import init_params
    from ..models.zoo import PREPROC_CONV0, save_tree_npz
    from ..wct.engine import resolve_device
    from .normalize_vgg import normalize_encoder

    dev = resolve_device(device)
    if calib_batches is None:
        calib_batches = synth_calibration_batches(n_images, batch, size, seed)
    gen = torch.Generator().manual_seed(seed)
    for k in sorted(stages):
        espec, dspec = encoder_spec("original", k), decoder_spec("original", k)
        enc = init_params(espec, gen, device=dev)
        if espec.has_conv0:
            enc["conv0"] = {kind: torch.from_numpy(a).to(dev) for kind, a in PREPROC_CONV0.items()}
        # random teachers have near-dead ReLU filters: floor them so that the
        # normalization scale cannot explode (cli.normalize_vgg on real
        # weights keeps the reference's semantics, floor off)
        enc = normalize_encoder(enc, espec, calib_batches, rel_floor=1e-2)
        dec = init_params(dspec, gen)
        epath = os.path.join(out_root, "original", f"e{k}.npz")
        dpath = os.path.join(out_root, "original", f"d{k}.npz")
        save_tree_npz(enc, epath)
        save_tree_npz(dec, dpath)
        log(f"stage {k}: synthetic normalized teacher -> {epath}, {dpath}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="weights", help="weight store root")
    ap.add_argument("--stages", type=int, nargs="+", default=[1, 2, 3, 4, 5],
                    choices=[1, 2, 3, 4, 5])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--images", default="",
                    help="calibration image folder (default: synthetic blobs)")
    ap.add_argument("--n_images", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="where the normalization runs: cuda (default; raises without "
                         "CUDA) or cpu")
    args = ap.parse_args(argv)

    calib = None
    if args.images:
        from ..data.pipeline import CenterCropDataset
        ds = CenterCropDataset(args.images, shorter_side=args.size + 16, crop=args.size)
        n = min(args.n_images, len(ds))
        calib = [np.stack([ds[j][0] for j in range(i, min(i + args.batch, n))])
                 for i in range(0, n, args.batch)]
    build_synthetic_teacher(args.out, args.stages, seed=args.seed, calib_batches=calib,
                            n_images=args.n_images, batch=args.batch, size=args.size,
                            device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
