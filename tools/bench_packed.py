#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 5e alone: the UHD slab and slab-in-shard
cascades with each encoder's ``conv0`` folded into its ``conv1_1``
(``WCTEngine(packed=None)``, the default) against ``packed=False``.

Builds the kernels, reflect-tiles the photo pair to 4096 x 10240 content and
2048^2 style, and calls ``chip_smoke.packed_phase``: per path and dtype
(float32, bf16) the folded conv1_1 against the plain conv at each stage's
first window, the PSNR of folded against unfolded (bf16: each against the
float32 folded output), warm medians of 3 in turns, spreads, peaks, idle
shares and the profiler's ``conv0`` products. Its lines start "phase 5e";
the results go to ``chiprun_out/bench_packed.json``, then the card's name
and power limit print. Needs one CUDA device (~80 s with the build):

    python3 tools/bench_packed.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_packed: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from collaborative_distillation_tpu_torch.ops import cuda as kc
    from collaborative_distillation_tpu_torch.ops.cuda import _build
    from collaborative_distillation_tpu_torch.utils.flops import card_peak_flops
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    cs.PEAK_FP32_FLOPS = card_peak_flops(0, "float32")[0]
    cs.PEAK_BF16_FLOPS = card_peak_flops(0, "bfloat16")[0]
    t0 = time.perf_counter()
    _build.library()
    cs.log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    with np.load(os.path.join(HERE, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c512, s512 = d["content"], d["style"]
    s2k = cs.reflect_tile(torch, s512, 2048)
    c_uhd = cs.reflect_tile(torch, c512, cs.UHD_H, cs.UHD_W)
    out = cs.packed_phase(torch, kc, WCTEngine, c_uhd, s2k, smi)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "bench_packed.json"), "w") as f:
        json.dump({"card": smi, **out}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
