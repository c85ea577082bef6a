#!/usr/bin/env python3
"""What folding ``conv0`` into ``conv1_1`` costs the bf16 slab path in
accuracy, in the port and in the JAX package, on the CPU.

On ``tests/test_torch_bf16.py``'s crop of the photo pair (704 x 64 content
from the 256^2 crop, 64^2 style, ``slab_rows=288``, shipped ``16x``
weights) it prints one JSON line: the PSNR against the port's float32 plain
output of the port's bf16 plain engine, the bf16 slab engines of both
packages with ``packed`` on and off, and the port's folded bf16 slab engine
with each folded ``conv1_1`` bias kept in float32 (an experiment, not a
path of the port). PSNR is computed on the host; no time is measured.

    python3 tools/fold_accuracy.py [--threads 4]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")   # before any backend starts
    import jax.numpy as jnp
    import torch
    from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine
    from collaborative_distillation_tpu_torch.models import packed_vgg
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

    torch.set_num_threads(args.threads)
    root = os.path.join(HERE, "weights")
    with np.load(os.path.join(HERE, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c = d["content"][:256, :256].astype(np.float32) / 255
        s = d["style"][:256, :256].astype(np.float32) / 255
    tall, sty = np.concatenate([c, c[::-1], c])[:704, :64], s[:64, :64]

    def psnr(a, b):
        a = np.asarray(a, np.float64)
        return float(10 * np.log10(1 / np.mean((a - b) ** 2)))

    bf = torch.bfloat16
    ref = WCTEngine(mode="16x", weights_root=root, device="cpu").stylize(tall, sty)
    out = {"port_bf16_plain": psnr(WCTEngine(mode="16x", weights_root=root, device="cpu",
                                             dtype=bf).stylize(tall, sty), ref)}
    for packed in (False, True):
        out[f"port_bf16_slab_packed_{packed}"] = psnr(WCTEngine(
            mode="16x", weights_root=root, device="cpu", dtype=bf, slab_rows=288,
            packed=packed).stylize(tall, sty), ref)
        out[f"jax_bf16_slab_packed_{packed}"] = psnr(np.asarray(JaxEngine(
            mode="16x", weights_root=root, dtype=jnp.bfloat16, slab_rows=288,
            packed=packed).stylize(tall, sty), np.float32), ref)
    eng = WCTEngine(mode="16x", weights_root=root, device="cpu", dtype=bf, slab_rows=288)
    for k in eng.stages:
        spec, first = eng.pyramid[k]["enc_spec"], eng.pyramid[k]["enc_spec"].layers[0].name
        f32 = packed_vgg.pack_stage_params(
            {n: {kk: v.float() for kk, v in leaf.items()}
             for n, leaf in eng.pyramid[k]["enc"].items()}, spec)
        enc = eng.slab.packed_params[k]["enc"]
        enc[first] = {"w": enc[first]["w"], "b": f32[first]["b"]}
    out["port_bf16_slab_folded_f32_bias"] = psnr(eng.stylize(tall, sty), ref)
    print(json.dumps({"threads": args.threads, "psnr_vs_port_f32_plain_db": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
