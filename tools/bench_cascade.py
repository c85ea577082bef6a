#!/usr/bin/env python3
"""Time the warm 2048^2 plain, UHD slab and slab-in-shard UHD cascades of
one checkout.

For the checkout at ``--root`` (default: this one) it prints one JSON line:
``WCTEngine(mode="16x", dtype=...)`` on the photo pair reflect-tiled to
2048^2 (content and style) and to 4096 x 10240 (``slab_rows=1024``, 2048^2
style; and ``space=4``, ``slab_rows=512``, the four shards on ``cuda:0``),
each cascade device-resident after one untimed call: the median, the spread
(max - min) and every run of 5 (2048^2) and 3 (UHD) warm cascades, host
clock around ``stylize_device`` and ``torch.cuda.synchronize()``, as
``chip_smoke.py`` phases 5, 5b, 5c and 10 time them; the peak memory; the
output's SHA-256 (float32 bytes: equal where two checkouts compute the same
bits); and the profiler's device busy, idle share, conv kernels' and halo
kernels' device time of one more cascade (``chip_smoke.profile_cascade``).
Then the card's name and power limit. ``--paths`` picks cascades.

The inputs and timers are this checkout's ``chip_smoke.py``; the package and
its kernels are ``--root``'s. So two versions are compared on one card in
turns, parent, change, change, parent, with the parent unpacked under the
ignored ``build/checkouts/`` (``git archive``):

    python3 tools/bench_cascade.py --root build/checkouts/parent [--dtype bfloat16]
        [--paths 2048 uhd sharded]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--paths", nargs="+", default=["2048", "uhd", "sharded"],
                    choices=("2048", "uhd", "sharded"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_cascade: needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with np.load(os.path.join(HERE, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c512, s512 = d["content"], d["style"]
    c2k, s2k = cs.reflect_tile(torch, c512, 2048), cs.reflect_tile(torch, s512, 2048)
    c_uhd = cs.reflect_tile(torch, c512, cs.UHD_H, cs.UHD_W)
    kw = {} if args.dtype == "float32" else {"dtype": torch.bfloat16}
    out = {"root": root, "dtype": args.dtype}
    engines = {
        "2048": lambda: (WCTEngine(mode="16x", **kw), c2k, 5),
        "uhd": lambda: (WCTEngine(mode="16x", slab_rows=cs.UHD_SLAB, **kw), c_uhd, 3),
        "sharded": lambda: (WCTEngine(mode="16x", space=cs.SHARDS, slab_rows=cs.SHARD_SLAB,
                                      devices=["cuda:0"] * cs.SHARDS, **kw), c_uhd, 3)}
    for label in args.paths:
        eng, c, n = engines[label]()
        with torch.inference_mode():
            img, sty = eng._prep(c), eng._prep(s2k)
            sha = hashlib.sha256(
                eng.stylize_device(img, sty).float().cpu().numpy().tobytes()).hexdigest()
            torch.cuda.synchronize()   # the kernels are built, the allocator warm
            torch.cuda.reset_peak_memory_stats()
            runs = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.stylize_device(img, sty)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            prof = cs.profile_cascade(torch, eng, img, sty, f"bench_cascade ({label})")
            del img, sty
        out[label] = {"median_ms": statistics.median(runs), "spread_ms": max(runs) - min(runs),
                      "runs_ms": runs, "peak_gib": peak, "sha256": sha,
                      **{k: prof.get(k) for k in ("busy_ms", "idle_share", "conv3x3_ms",
                                                  "bf16_conv_ms", "halo_ms", "halo_calls")}}
        del eng
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
