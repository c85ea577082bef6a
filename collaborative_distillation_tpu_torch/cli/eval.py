"""Evaluate autoencoder fidelity of a model family, per pyramid stage.

* reconstruction PSNR/SSIM/MSE of ``dec_k(enc_k(x))`` against ``x`` per
  stage, what the distillation's pixel loss optimizes;
* with ``--teacher_root``, the per-stage feature-distillation error between
  the student encoder's aux-adapted taps and the teacher's taps.

    python -m collaborative_distillation_tpu_torch.cli.eval --mode 16x \\
        --images <dir> --n_images 16 --size 256

The encoders and decoders run on the GPU unless ``--device cpu``; the
metrics are numpy on the host.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def _gauss_filter(x: np.ndarray, win: int = 11, sigma: float = 1.5) -> np.ndarray:
    """Separable Gaussian over the H, W axes of (N, H, W, C), 'valid' edges
    (the standard SSIM prescription drops the border instead of padding)."""
    from numpy.lib.stride_tricks import sliding_window_view

    g = np.exp(-0.5 * ((np.arange(win) - win // 2) / sigma) ** 2)
    g /= g.sum()
    x = sliding_window_view(x, win, axis=1) @ g  # (N, H', W, C)
    return sliding_window_view(x, win, axis=2) @ g  # (N, H', W', C)


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 1.0, *, win: int = 11,
         sigma: float = 1.5) -> float:
    """Mean single-scale SSIM (Wang et al. 2004: 11x11 Gaussian window,
    sigma 1.5, k1=0.01, k2=0.03), channels treated as independent planes and
    averaged. Inputs (N, H, W, C) or (H, W, C) in [0, peak]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        a, b = a[None], b[None]
    c1, c2 = (0.01 * peak) ** 2, (0.03 * peak) ** 2
    mu_a = _gauss_filter(a, win, sigma)
    mu_b = _gauss_filter(b, win, sigma)
    var_a = _gauss_filter(a * a, win, sigma) - mu_a * mu_a
    var_b = _gauss_filter(b * b, win, sigma) - mu_b * mu_b
    cov = _gauss_filter(a * b, win, sigma) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))


def run(argv=None) -> dict:
    """Parse ``argv``, evaluate, print the table; returns {stage: metrics}."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", default="16x",
                    help="family to evaluate (original | 16x | 16x_kd2sd)")
    ap.add_argument("--images", required=True, help="directory of images")
    ap.add_argument("--n_images", type=int, default=16)
    ap.add_argument("--size", type=int, default=256, help="center-crop size")
    ap.add_argument("--stages", type=int, nargs="+", default=[5, 4, 3, 2, 1])
    ap.add_argument("--weights_root", type=str, default="")
    ap.add_argument("--teacher_root", type=str, default="",
                    help="weights root holding original/e{k}.npz teachers; "
                         "adds the SE-vs-BE feature-distillation error")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the encoders and decoders run (default the GPU)")
    args = ap.parse_args(argv)

    from ..wct.engine import resolve_device
    device = resolve_device(args.device)   # before any work: no CUDA, no run

    import torch

    from ..data.pipeline import CenterCropDataset
    from ..models.specs import encoder_spec
    from ..models.vgg import apply_decoder, apply_encoder
    from ..models.zoo import load_pyramid, load_stage_params

    pyramid = load_pyramid(args.mode, args.weights_root or None,
                           stages=tuple(args.stages), device=device)
    ds = CenterCropDataset(args.images, shorter_side=args.size + 16, crop=args.size,
                           device=device)
    n = min(args.n_images, len(ds))
    if n == 0:
        raise SystemExit(f"no images found under {args.images}")
    imgs = np.stack([ds[i][0] for i in range(n)])  # (N, H, W, 3) float [0,1]

    teachers = {}
    if args.teacher_root:
        for k in args.stages:
            spec = encoder_spec("original", k)
            teachers[k] = (load_stage_params(f"{args.teacher_root}/original/e{k}.npz", spec,
                                             device), spec)

    results = {}
    with torch.no_grad():
        x = torch.from_numpy(imgs).to(device)
        for k in args.stages:
            p = pyramid[k]
            es, dsx = p["enc_spec"], p["dec_spec"]
            feats = apply_encoder(p["enc"], x, es, aux=False)["out"]
            rec = np.clip(apply_decoder(p["dec"], feats, dsx)["out"].cpu().numpy(), 0.0, 1.0)
            row = {"psnr": round(psnr(rec, imgs), 2),
                   "ssim": round(ssim(rec, imgs), 4),
                   "mse": round(float(np.mean((rec - imgs) ** 2)), 6)}
            if k in teachers and es.aux:
                # the wct_se feature loss: student aux taps (adapted up to
                # teacher widths) against the teacher's relu taps; an
                # aux-less family simply omits the metric
                tp, tspec = teachers[k]
                taps_s = apply_encoder(p["enc"], x, es)
                taps_t = apply_encoder(tp, x, tspec)
                errs = [torch.mean((taps_s[m] - taps_t["relu" + m[3:]]) ** 2)
                        for m in taps_s if m.startswith("aux") and ("relu" + m[3:]) in taps_t]
                row["feat_mse"] = round(float(torch.mean(torch.stack(errs))), 6)
            results[k] = row
            print(f"stage {k}: " + "  ".join(f"{m}={v}" for m, v in row.items()), flush=True)
    mean_psnr = np.mean([r["psnr"] for r in results.values()])
    print(f"mean reconstruction PSNR over stages {args.stages}: "
          f"{mean_psnr:.2f} dB ({n} images @ {args.size}px, mode {args.mode})")
    return results


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
