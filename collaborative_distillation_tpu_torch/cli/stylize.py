"""Inference CLI: universal style transfer over content x style grids.

The reference package's stylize CLI (the ``PytorchWCT/WCT.py`` flag
surface) on the port's engine:

    python -m collaborative_distillation_tpu_torch.cli.stylize --mode 16x \\
        --contentPath .../content --stylePath .../style --outf stylized_results

Runs on the GPU unless ``--device cpu``. One pair goes through
``stylize(..., as_uint8=True)`` (at UHD with ``--slab_rows`` the last stage
streams to the host); several through ``stylize_pairs``, which overlaps one
pair's upload and another's readback with the cascade. Outputs are named
``<log_mark>_mode=<mode>_alpha=<alpha>_<content>+<style>.jpg``; where the
native JPEG codec is unavailable the same stem is written as ``.png`` and
the log says why. ``--bf16``, ``--packed`` and ``--halo pallas`` have no
counterpart in the port and are refused.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import deque

NO_COUNTERPART = ("has no counterpart in the PyTorch port (float32 NHWC kernels; the "
                  "row halos are the hand-written CUDA kernel)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--UHD_contentPath", type=str, default="content/UHD_content")
    ap.add_argument("--UHD_stylePath", type=str, default="style/UHD_style")
    ap.add_argument("--contentPath", type=str, default="content")
    ap.add_argument("--stylePath", type=str, default="style")
    ap.add_argument("--texturePath", type=str, default="style/texture")
    ap.add_argument("--outf", type=str, default="stylized_results")
    ap.add_argument("--picked_content_mark", type=str, default="")
    ap.add_argument("--picked_style_mark", type=str, default="")
    ap.add_argument("--mode", type=str, default="original",
                    choices=["original", "16x", "16x_kd2sd", "16x_base"])
    ap.add_argument("--UHD", action="store_true")
    ap.add_argument("--synthesis", action="store_true", help="texture synthesis from noise")
    ap.add_argument("--content_size", type=int, default=0)
    ap.add_argument("--style_size", type=int, default=0)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--log_mark", type=str, default=time.strftime("%Y%m%d-%H%M"))
    ap.add_argument("--num_run", type=int, default=1)
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--method", type=str, default="eigh", choices=["eigh", "newton"],
                    help="WCT matrix-root algorithm")
    ap.add_argument("--space", type=int, default=0,
                    help="cut each image's rows over N cards, one shard per visible card "
                         "(0 = one card); raises with fewer cards")
    ap.add_argument("--bf16", action="store_true",
                    help="refused: bfloat16 activations " + NO_COUNTERPART)
    ap.add_argument("--weights_root", type=str, default="")
    ap.add_argument("--slab_rows", type=int, default=0,
                    help="stream in row slabs of N rows (single-card UHD)")
    ap.add_argument("--packed", action="store_true",
                    help="refused: the width-packed pipeline " + NO_COUNTERPART)
    ap.add_argument("--transport", default="auto", choices=["auto", "rgb", "yuv420"],
                    help="host<->device image transport; yuv420 moves JPEG-native "
                         "4:2:0 planes (half the link bytes)")
    ap.add_argument("--halo", default="ppermute", choices=["ppermute", "pallas"],
                    help="the row halos of --space: the port's CUDA kernel "
                         "(ppermute, the default); pallas is refused: it " + NO_COUNTERPART)
    ap.add_argument("--profile", type=str, default="",
                    help="write a torch.profiler Chrome trace into this dir")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the cascade runs (default the GPU; cpu takes the plain "
                         "PyTorch path)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, refused in (("--bf16", args.bf16), ("--packed", args.packed),
                          ("--halo pallas", args.halo == "pallas")):
        if refused:
            ap.error(f"{flag} {NO_COUNTERPART}")

    from ..wct.engine import WCTEngine, resolve_device
    device = resolve_device(args.device)   # before any work: no CUDA, no run

    import numpy as np

    from ..data.pipeline import PairGridDataset
    from ..utils.image import jpeg_or_png, save_image
    from ..utils.logging import LogPrinter, Throughput
    from ..utils.profiling import trace

    os.makedirs(args.outf, exist_ok=True)
    log_path = os.path.join(args.outf, f"log_{args.log_mark}_{args.mode}.txt")
    log = LogPrinter(None if args.debug else open(log_path, "a+"),
                     args.log_mark, to_screen=args.debug)
    log(str(vars(args)))

    content_dir = args.UHD_contentPath if args.UHD else args.contentPath
    style_dir = args.UHD_stylePath if args.UHD else args.stylePath
    dataset = PairGridDataset(
        content_dir, style_dir, texture_dir=args.texturePath,
        content_size=args.content_size, style_size=args.style_size,
        picked_content_mark=args.picked_content_mark,
        picked_style_mark=args.picked_style_mark, synthesis=args.synthesis)
    log(f"Number of content-style pairs: {len(dataset)}")

    engine = WCTEngine(mode=args.mode, weights_root=args.weights_root or None,
                       method=args.method, space=args.space, slab_rows=args.slab_rows,
                       transport=args.transport, device=device)
    tp = Throughput()
    total_t = 0.0
    # pipelined across pairs: pair i+1's decode and upload and pair i-1's
    # readback overlap pair i's cascade; the pair generator is lazy, one
    # pair decoded ahead
    meta: deque = deque()

    def pair_gen():
        for i in range(len(dataset)):
            c, s, name = dataset[i]
            meta.append((name, c.shape))
            yield ((c * 255).astype(np.uint8), (s * 255).astype(np.uint8))

    keys = (dataset.pairs[i][1] for i in range(len(dataset)))

    def results():
        if len(dataset) == 1:
            # one pair (the UHD use): no cross-pair pipeline to feed, so
            # stylize directly and let the streamed last stage overlap the
            # readback (stylize_pairs keeps the cascade whole)
            (c, s), key = next(iter(zip(pair_gen(), keys)))
            yield engine.stylize(c, s, alpha=args.alpha, num_run=args.num_run,
                                 style_key=key, as_uint8=True)
        else:
            yield from engine.stylize_pairs(pair_gen(), alpha=args.alpha,
                                            num_run=args.num_run, style_keys=keys)

    t_prev = time.time()
    with trace(args.profile):
        for i, out in enumerate(results()):
            name, cshape = meta.popleft()
            log("*" * 30 + f' #{i}: Transferred "{name}"')
            out_name = f"{args.log_mark}_mode={args.mode}_alpha={args.alpha}_{name}"
            path, why = jpeg_or_png(os.path.join(args.outf, out_name))
            if why:
                log(f"writing {os.path.basename(path)} as PNG: {why}")
            save_image(out, path)
            dt = time.time() - t_prev
            t_prev = time.time()
            total_t += dt
            tp.tick(cshape[0] * cshape[1])
            log(f"Elapsed time is: {dt:.4f} seconds")
    if len(dataset):
        log(f"Processed {len(dataset)} images. Average processing time per pair: "
            f"{total_t / len(dataset):.4f} seconds ({tp.report()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
