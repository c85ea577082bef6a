#!/usr/bin/env python3
"""Time the port's ``sum_gram`` kernel per shape on one CUDA card.

At every shape that the mode-16x cascade gives the kernel, on the 2048^2
plain path (10 launches) and on the 4096 x 10240 ``slab_rows=1024`` slab
path (25 launches), it holds the kernel against its plain version (the
tolerance of ``chip_smoke.py``) and times the kernel, the plain version and
``x.T @ x`` with CUDA events, beside the least time the card could take,
and the kernels' own device time per call with torch.profiler.
Prints one JSON line per shape and one per path, the time of a one-row
call (the floor of a call's cost), and the card's name and power limit.

    python3 tools/bench_sum_gram.py [--root CHECKOUT]

``--root`` imports ``chip_smoke.py`` and the port from another checkout
(for example an older commit unpacked into a directory that ``.gitignore``
lists), so that two versions are timed on one card in turns.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (rows, channels) per stage: the encoder's output map at stages 1..5
PLAIN_2048 = [((2048 >> s) ** 2, c) for s, c in enumerate((24, 32, 64, 128, 128))]
SLAB_ROWS, UHD_W = 1024, 10240
UHD_SLABS = 4
REPS = 10                    # calls timed per shape, after two warm-ups
PATHS = {
    # style and content at 2048^2: two launches per stage
    "2048^2 plain": [(shape, 2) for shape in PLAIN_2048],
    # the 2048^2 style once per stage, each of 4 slabs' interior rows once
    "UHD slab": [(shape, 1) for shape in PLAIN_2048]
    + [(((SLAB_ROWS >> s) * (UHD_W >> s), c), UHD_SLABS)
       for s, c in enumerate((24, 32, 64, 128, 128))],
}


def device_ms(torch, fn, reps) -> dict:
    """Device time per call by kernel, from torch.profiler: what the card
    spends, without the host's share of a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            by[e.key.replace("void (anonymous namespace)::", "")[:60]] = us / reps / 1e3
    return by


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_sum_gram: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke
    from collaborative_distillation_tpu_torch.ops import cuda as kc
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    bench = chip_smoke.Bench(torch, None)
    # one row: what a call costs the host and the card when there is no work
    for shape in ((1, 24), (1, 128)):
        r = bench.run("sum_gram", shape, timed=True, reps=REPS)
        print(json.dumps({"floor": list(shape), "ms": r["ms"]}), flush=True)
    rows = {}
    for path, shapes in PATHS.items():
        tot = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "launches": 0}
        for shape, n in shapes:
            if shape not in rows:
                r = bench.run("sum_gram", shape, timed=True, reps=REPS)
                r["bound_ms"] = max(r["bytes_ms"], r["flops_ms"])
                x = torch.rand(shape, device="cuda") * 4 + 10
                shift = x[:4096].mean(0)
                by = device_ms(torch, lambda: kc.sum_gram(x, shift), REPS)
                del x
                r["device_ms"] = sum(by.values())
                rows[shape] = r
                print(json.dumps({"shape": list(shape), **{k: r[k] for k in (
                    "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                    "flops_ms", "max_rel_err")}, "by_kernel_ms": by}), flush=True)
            r = rows[shape]
            for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
                tot[k] += r[k] * n
            tot["launches"] += n
        print(json.dumps({"path": path, **tot, "root": os.path.abspath(args.root),
                          "source": kc.sum_gram.__module__}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
