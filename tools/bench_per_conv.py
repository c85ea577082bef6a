#!/usr/bin/env python3
"""Time the warm per-conv sharded cascade of one checkout.

For the checkout at ``--root`` (default: this one) it prints one JSON line:

* ``per_conv``: ``chip_smoke.per_conv_timing`` of ``WCTEngine(mode="16x",
  space=4)`` with its four shards dealt over ``--cards`` cards (1: all on
  ``cuda:0``; 4: one a card) at 2048^2 and at 2000 x 2048 content (the
  photo pair reflect-tiled, 2048^2 style): median of 5, peak memory per
  card, launches, and on one card device busy, idle share and the
  profiler's top device time by kernel;
* ``conv3x3``: the conv3x3 kernel without halo rows at every conv shape of
  the 2048^2 plain cascade: the time summed over a cascade's calls (CUDA
  events, mean of 10 after two warm-ups) and ``chip_smoke.conv3x3_sha256``,
  a SHA-256 of its outputs on inputs made from one seed, which is equal
  across two checkouts whose kernels compute the same bits;
* ``ptxas``: the register and spill lines of the conv3x3 kernels from the
  build log.

The timing functions are this checkout's ``chip_smoke.py``; the package,
the kernels and the engine are ``--root``'s. So two versions are compared on
one card in turns, parent, change, change, parent, with the parent unpacked
under the ignored ``build/checkouts/`` (``git archive``):

    python3 tools/bench_per_conv.py --root build/checkouts/parent [--cards 4]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--cards", type=int, default=1, help="cards the four shards are dealt over")
    args = ap.parse_args()
    import numpy as np
    import torch
    if torch.cuda.device_count() < args.cards:
        print(f"bench_per_conv: needs {args.cards} CUDA devices", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from collaborative_distillation_tpu_torch.ops import cuda as kc
    from collaborative_distillation_tpu_torch.ops.cuda import _build
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    ptxas, entry = [], ""
    for line in _build.last_build["log"].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "conv3x3" in entry and ("registers" in line or "spill" in line):
            ptxas.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    with np.load(os.path.join(root, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c512, s512 = d["content"], d["style"]
    per_conv = WCTEngine(mode="16x", space=cs.SHARDS,
                         devices=[f"cuda:{i % args.cards}" for i in range(cs.SHARDS)])
    with torch.inference_mode():
        img = per_conv._prep(cs.reflect_tile(torch, c512, 2048))
        sty = per_conv._prep(cs.reflect_tile(torch, s512, 2048))
    timed = [cs.per_conv_timing(torch, kc, per_conv, img[:, :h], sty, f"{root} ({h}x2048)")
             for h in (2048, cs.PC_AWK_H)]
    # the conv kernel without halo rows at the 2048^2 plain path's shapes
    calls, _ = cs.path_calls(per_conv.pyramid, per_conv.stages, 2048, 2048)
    conv_ms = 0.0
    with torch.no_grad():
        for (kernel, shape), n in sorted(calls.items(), key=str):
            if kernel != "conv3x3_reflect":
                continue
            b_, h, w, ci, co, relu = shape[:6]
            x = torch.rand((b_, h, w, ci), device="cuda")
            wt = (torch.rand((3, 3, ci, co), device="cuda") - 0.5) * 0.1
            b = torch.rand((co,), device="cuda") - 0.5
            conv_ms += cs.cuda_ms(torch, lambda: kc.conv3x3_reflect(x, wt, b, relu), 10) * n
    print(json.dumps({"root": root, "card": card, "cards": args.cards, "per_conv": timed,
                      "conv3x3": {"ms_2048_cascade": conv_ms,
                                  "sha256": cs.conv3x3_sha256(torch, kc, calls)},
                      "ptxas": ptxas}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
