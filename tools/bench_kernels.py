#!/usr/bin/env python3
"""Time one of the port's kernels per shape of the mode-16x paths on one card.

At every shape that the 2048^2 plain cascade and the 4096 x 10240
``slab_rows=1024`` slab cascade give the kernel, it holds the kernel against
its plain version (``chip_smoke.py``'s check and tolerance) and times it with
CUDA events (mean of 10 calls after two warm-ups) and with torch.profiler
(the kernel's own device time per call), beside the least time the card
could take (``chip_smoke.work``). With ``--reference`` it also times the
plain version and the library call (``chip_smoke.Bench``'s: cuDNN with a
reflect pad, ``torch.addmm``, ``x.T @ x``) and a device-to-device copy of
the same bytes (``copy_ms``: what the card's memory system gives a pure
stream of the kernel's bytes, half read and half written). Prints one JSON
line per shape (with the conv3x3 launch plan's template where the checkout
has one), one per path (sums weighted by the calls per cascade), and the
card's name and power limit.

    python3 tools/bench_kernels.py --kernel {sum_gram,conv1x1_bias,conv3x3_reflect}
        [--root CHECKOUT] [--reference] [--paths "2048^2 plain" "UHD slab"]

``--root`` imports ``chip_smoke.py`` and the port from another checkout, for
example the parent commit unpacked with ``git archive`` under the ignored
``build/checkouts/``, so that two versions are timed on one card in turns:
run parent, change, change, parent in one command.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPS = 10                    # calls timed per shape, after two warm-ups
STAGES = (5, 4, 3, 2, 1)
PATHS = ("2048^2 plain", "UHD slab")


def device_ms(torch, fn, reps) -> dict:
    """Device time per call by kernel name, from torch.profiler: what the
    card spends, without the host's share of a call."""
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
            by[e.key.replace("void (anonymous namespace)::", "")[:70]] = us / reps / 1e3
    return by


def path_shapes(chip_smoke, kernel) -> dict:
    """{path: {shape: calls per cascade}} of ``kernel`` on the two paths,
    from the checkout's own plans and the mode-16x specs."""
    from collaborative_distillation_tpu_torch.models.zoo import stage_specs
    from collaborative_distillation_tpu_torch.wct.slab import FEATURE_CACHE_BYTES, SlabCascade
    pyr = {k: dict(zip(("enc_spec", "dec_spec"), stage_specs("16x", k))) for k in STAGES}
    cas = SlabCascade(pyr, stages=STAGES, slab_rows=chip_smoke.UHD_SLAB)
    plans = {
        "2048^2 plain": chip_smoke.path_calls(pyr, STAGES, 2048, 2048)[0],
        "UHD slab": chip_smoke.slab_path_calls(pyr, STAGES, cas.margins, cas.slab_rows,
                                               chip_smoke.UHD_H, chip_smoke.UHD_W, 2048, 2048,
                                               FEATURE_CACHE_BYTES)[0],
    }
    return {p: {s: n for (k, s), n in calls.items() if k == kernel} for p, calls in plans.items()}


def make_call(torch, kc, kernel, shape):
    """The kernel on fresh inputs at ``shape`` (the path's own key)."""
    k = getattr(kc, kernel)
    if kernel == "conv3x3_reflect":
        n, h, w, ci, co, relu = shape[:6]
        x = torch.rand(n, h, w, ci, device="cuda")
        wt = (torch.rand(3, 3, ci, co, device="cuda") - 0.5) * (2 / (9 * ci) ** 0.5)
        b = torch.rand(co, device="cuda") - 0.5
        return lambda: k(x, wt, b, relu)
    if kernel == "conv1x1_bias":
        n, h, w, ci, co, relu, bias = shape[:7]
        x = torch.rand(n, h, w, ci, device="cuda") - 0.5
        wt = (torch.rand(ci, co, device="cuda") - 0.5) * (2 / ci ** 0.5)
        b = torch.rand(co, device="cuda") - 0.5 if bias else None
        return lambda: k(x, wt, b, relu)
    p, c = shape[:2]
    x = torch.rand(p, c, device="cuda") * 4 + 10
    shift = x[:4096].mean(0)
    return lambda: k(x, shift)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", required=True,
                    choices=("sum_gram", "conv1x1_bias", "conv3x3_reflect"))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reference", action="store_true",
                    help="also time the plain version and the library call")
    ap.add_argument("--paths", nargs="+", default=list(PATHS), choices=PATHS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    from collaborative_distillation_tpu_torch.ops import cuda as kc
    try:   # the conv3x3 launch plan, where the checkout has one
        from collaborative_distillation_tpu_torch.ops.cuda.conv import device_plan
    except ImportError:
        device_plan = None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    bench = chip_smoke.Bench(torch, None)
    shapes = path_shapes(chip_smoke, args.kernel)
    rows = {}
    for path in args.paths:
        keys = ("ms", "device_ms", "bound_ms") + (
            ("plain_ms", "library_ms", "copy_ms") if args.reference else ())
        tot = dict.fromkeys(keys, 0.0)
        tot["launches"] = 0
        for shape, n in sorted(shapes[path].items(), key=str):
            if shape not in rows:
                with torch.no_grad():
                    chk = bench.run(args.kernel, shape, timed=args.reference, reps=REPS)
                    call = make_call(torch, kc, args.kernel, shape)
                    r = {"ms": chip_smoke.cuda_ms(torch, call, REPS)}
                    by = device_ms(torch, call, REPS)
                    del call
                nbytes, flops = chip_smoke.work(args.kernel, shape)
                bytes_ms = nbytes / chip_smoke.PEAK_BYTES * 1e3
                flops_ms = flops / chip_smoke.PEAK_FP32_FLOPS * 1e3
                r.update(device_ms=sum(by.values()), bound_ms=max(bytes_ms, flops_ms),
                         bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                         max_rel_err=chk["max_rel_err"], by_kernel_ms=by)
                if args.reference:
                    r.update(plain_ms=chk["plain_ms"], library_ms=chk["library_ms"])
                    src = torch.empty(nbytes // 8, device="cuda")
                    dst = torch.empty_like(src)
                    r["copy_ms"] = chip_smoke.cuda_ms(torch, lambda: dst.copy_(src), REPS)
                    del src, dst
                if args.kernel == "conv3x3_reflect":
                    r["plan"] = device_plan(*shape[:5], 0).kernel if device_plan else "first"
                rows[shape] = r
                print(json.dumps({"shape": list(shape), **r}), flush=True)
            r = rows[shape]
            for k in keys:
                tot[k] += r[k] * n
            tot["launches"] += n
        print(json.dumps({"path": path, "kernel": args.kernel, **tot, "root": root}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
