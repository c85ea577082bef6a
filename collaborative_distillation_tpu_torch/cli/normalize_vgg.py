"""Gatys-style activation normalization of a VGG encoder.

Rescales each conv's weights and bias so that the mean activation of every
filter over a set of calibration images is 1, and carries the previous
layer's scale into the next layer's input weights (the reference's
tools/convert_caffemodel_to_pth/normalise_vgg/normalise_pth.py:245-268).
This is how the "vgg_normalised" WCT teachers were made; needed only to
(re)build teachers from raw VGG weights.

    python -m collaborative_distillation_tpu_torch.cli.normalize_vgg \
        --weights weights/original/e5.npz --stage 5 \
        --images data/val/ --out weights/original/e5_norm.npz

The taps run the port's ``conv3x3`` and ``max_pool_2x2``: the kernels on the
card (``--device cuda``, the default), their plain versions with ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops.conv import conv1x1, conv3x3, max_pool_2x2


def _layer_mean(params, spec, x: torch.Tensor, name: str) -> torch.Tensor:
    """Per-filter mean of layer ``name``'s (ReLU'd) output over a batch,
    running the encoder only as far as that layer."""
    if spec.has_conv0:
        x = conv1x1(x, params["conv0"]["w"], params["conv0"]["b"])
    for layer in spec.layers:
        x = conv3x3(x, params[layer.name]["w"], params[layer.name]["b"], relu=layer.relu)
        if layer.name == name:
            return x.mean(dim=(0, 1, 2))
        if layer.pool_after:
            x = max_pool_2x2(x)
    raise KeyError(f"no layer {name!r} in the {spec.family} stage-{spec.stage} encoder")


@torch.inference_mode()
def normalize_encoder(params, spec, batches, *, eps: float = 1e-12, rel_floor: float = 0.0):
    """A new params tree whose every filter has mean activation 1.

    ``params``: ``{layer: {"w", "b"}}`` tensors on one device, where the taps
    run; ``batches``: (N, H, W, 3) float arrays. Layer by layer, each
    filter's mean ReLU'd activation is taken under the already rescaled
    parameters, as the reference's sequential pass does: float32 means per
    batch, summed over the batches in float64 (weighted by batch size).

    ``rel_floor``: filters whose mean activation is below ``rel_floor`` x the
    layer's average are floored there before inverting. Off by default (the
    reference's semantics); synthetic teachers (:mod:`.make_teacher`) pass
    1e-2, so that a near-dead ReLU filter does not receive a ~1/eps rescale.
    """
    dev = next(iter(params.values()))["w"].device
    params = {n: dict(leaf) for n, leaf in params.items()}
    xs = [torch.as_tensor(np.asarray(b, np.float32)).to(dev) for b in batches]
    prev_scale = None
    for layer in spec.layers:
        name = layer.name
        if prev_scale is not None:
            params[name]["w"] = params[name]["w"] * prev_scale[:, None]
        total, sums = 0, 0.0
        for x in xs:
            sums = sums + _layer_mean(params, spec, x, name).double() * x.shape[0]
            total += x.shape[0]
        mean_act = (sums / total).float()
        floor = max(eps, rel_floor * float(mean_act.double().mean()))
        mean_act = torch.clamp(mean_act, min=floor)
        scale = 1.0 / mean_act
        params[name] = {"w": params[name]["w"] * scale, "b": params[name]["b"] * scale}
        prev_scale = mean_act  # the next layer's inputs shrank by 1/scale: multiply back
    return params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--stage", type=int, required=True, choices=[1, 2, 3, 4, 5])
    ap.add_argument("--family", default="original", choices=["original", "16x"])
    ap.add_argument("--images", required=True, help="calibration image folder")
    ap.add_argument("--n_images", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rel_floor", type=float, default=0.0,
                    help="floor mean activations at this fraction of the layer mean "
                         "before inverting (0 = reference semantics; use ~1e-2 for "
                         "synthetic teachers)")
    ap.add_argument("--device", default="cuda",
                    help="where the taps run: cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    from ..data.pipeline import CenterCropDataset
    from ..models.specs import encoder_spec
    from ..models.zoo import load_stage_params, save_tree_npz
    from ..wct.engine import resolve_device

    device = resolve_device(args.device)
    spec = encoder_spec(args.family, args.stage, aux=(args.family == "16x"))
    params = load_stage_params(args.weights, spec, device)
    ds = CenterCropDataset(args.images, shorter_side=args.size + 16, crop=args.size)
    n = min(args.n_images, len(ds))
    batches = [np.stack([ds[j][0] for j in range(i, min(i + args.batch, n))])
               for i in range(0, n, args.batch)]
    save_tree_npz(normalize_encoder(params, spec, batches, rel_floor=args.rel_floor), args.out)
    print(f"normalized {args.weights} over {n} images -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
