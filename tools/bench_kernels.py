#!/usr/bin/env python3
"""Time one of the port's kernels per shape of the port's paths on one card.

At every shape that the 2048^2 plain cascade and the 4096 x 10240
``slab_rows=1024`` slab cascade of mode 16x give the kernel (and, for
conv3x3, the teacher-width convs, Cin or Cout 256/512, of a wct_se training
step at stage 5 x 16 x 256^2 and of a mode-original 1024^2 cascade), it
holds the kernel against
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

    python3 tools/bench_kernels.py --kernel {sum_gram,conv1x1_bias,conv3x3_reflect,
        conv3x3_reflect_bf16,conv1x1_bias_bf16,conv3x3_pool,conv3x3_up,conv3x3_pool_bf16,
        conv3x3_up_bf16} [--root CHECKOUT] [--reference]
        [--paths "2048^2 plain" "UHD slab" "wct_se step" "original 1024^2"]
        [--template ID ...]

The fused conv + pool and upsample + conv (``conv3x3_pool``, ``conv3x3_up``
and their bf16 entries) run at the fused shapes of the paths, keyed by the
conv's map; with ``--reference`` beside the plain version, the two-kernel
sequence they replace (``pair_ms``) and cuDNN's conv with ``F.max_pool2d``
or ``F.interpolate``. In a checkout without them (``--root`` of a parent)
the same shapes time that checkout's two-kernel sequence instead (rows
marked ``"sequence": true``), so that parent and change compare shape by
shape.

The bf16 kernels run at the same shapes as their float32 kernels on the
bf16 engine's paths (``chip_smoke.BF16_OF``), on bf16 inputs, against the
bound with 2-byte elements at the card's bf16 tensor-core peak; their rows
name the bf16 launch plan's template where the checkout has one, and with
``--reference`` the conv3x3 adds cuDNN's bf16 conv alone on a map padded
and made channels-last outside the timed call (``library_conv_ms``).

``--template`` (conv3x3 only) times the listed ring templates of
``ops/cuda/conv.py:_TEMPLATES`` at every shape as well, launched through the
C entry with their own work items, beside the plan's: a tuning aid that
compares templates at shapes the plan gives to another one.

``--root`` imports the port from another checkout, for example the parent
commit unpacked with ``git archive`` under the ignored ``build/checkouts/``,
so that two versions are timed on one card in turns: run parent, change,
change, parent in one command. The shapes, checks and timers are this
checkout's ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10                    # calls timed per shape, after two warm-ups
STAGES = (5, 4, 3, 2, 1)
PATHS = ("2048^2 plain", "UHD slab")
TEACHER_PATHS = ("wct_se step", "original 1024^2")   # conv3x3 at Cin or Cout 256/512
FUSED = ("conv3x3_pool", "conv3x3_up")   # the conv with its pool or upsample folded in


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
    from the checkout's own plans and the mode-16x specs (a bf16 kernel:
    its float32 kernel's shapes, as the bf16 engine runs them)."""
    f32 = {b: f for f, b in chip_smoke.BF16_OF.items()}
    if kernel in f32:
        return {p: s for p, s in path_shapes(chip_smoke, f32[kernel]).items() if p in PATHS}
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
    out = {p: {s: n for (k, s), n in calls.items() if k == kernel} for p, calls in plans.items()}
    if kernel == "conv3x3_reflect":
        out.update(teacher_shapes(chip_smoke))
    return out


def teacher_shapes(chip_smoke) -> dict:
    """{path: {shape: calls}} of the conv3x3 launches at Cin or Cout 256/512:
    a wct_se training step (chip_smoke.py phase 8d) and one mode-original
    1024^2 cascade (phase 7f)."""
    pick = lambda calls: {s: n for s, n in calls.items() if chip_smoke.teacher_width(s)}
    return {"wct_se step": pick(chip_smoke.train_conv_calls("wct_se")),
            "original 1024^2": pick(chip_smoke.original_conv_calls(1024))}


def make_call(torch, kc, kernel, shape):
    """The kernel on fresh inputs at ``shape`` (the path's own key); a bf16
    kernel on the same values rounded to bf16 (the 1x1's bias float32). A
    fused conv that the checkout lacks: its conv and pool or upsample
    kernels in sequence."""
    bf = (lambda t: t.to(torch.bfloat16)) if kernel.endswith("_bf16") else (lambda t: t)
    if kernel.removesuffix("_bf16") in FUSED:
        n, h, w, ci, co, relu = shape[:6]
        pool = kernel.startswith("conv3x3_pool")
        x = bf(torch.rand(n, *((h, w) if pool else (h // 2, w // 2)), ci, device="cuda"))
        wt = bf((torch.rand(3, 3, ci, co, device="cuda") - 0.5) * (2 / (9 * ci) ** 0.5))
        b = bf(torch.rand(co, device="cuda") - 0.5)
        if hasattr(kc, kernel):
            return lambda: getattr(kc, kernel)(x, wt, b, relu)
        if pool:
            return lambda: kc.max_pool_2x2(kc.conv3x3_reflect(x, wt, b, relu))
        return lambda: kc.conv3x3_reflect(kc.upsample_nearest_2x(x), wt, b, relu)
    k = getattr(kc, kernel)
    if kernel.startswith("conv3x3_reflect"):
        n, h, w, ci, co, relu = shape[:6]
        x = bf(torch.rand(n, h, w, ci, device="cuda"))
        wt = bf((torch.rand(3, 3, ci, co, device="cuda") - 0.5) * (2 / (9 * ci) ** 0.5))
        b = bf(torch.rand(co, device="cuda") - 0.5)
        return lambda: k(x, wt, b, relu)
    if kernel.startswith("conv1x1_bias"):
        n, h, w, ci, co, relu, bias = shape[:7]
        x = bf(torch.rand(n, h, w, ci, device="cuda") - 0.5)
        wt = bf((torch.rand(ci, co, device="cuda") - 0.5) * (2 / ci ** 0.5))
        b = torch.rand(co, device="cuda") - 0.5 if bias else None
        return lambda: k(x, wt, b, relu)
    p, c = shape[:2]
    x = torch.rand(p, c, device="cuda") * 4 + 10
    shift = x[:4096].mean(0)
    return lambda: k(x, shift)


def template_call(torch, chip_smoke, kc, t, shape):
    """conv3x3 ring template ``t`` at ``shape``, through the C entry with
    the template's own plan: (call, max error over the largest partial sum
    against the plain version), or None where the template cannot take Cout."""
    from collaborative_distillation_tpu_torch.ops.cuda import _build
    from collaborative_distillation_tpu_torch.ops.cuda.conv import _TEMPLATES, ring_plan
    n, h, w, ci, co, relu = shape[:6]
    name, co_t = _TEMPLATES[t][:2]
    if co > co_t and not name.startswith("ring_walk"):
        return None
    x = torch.rand(n, h, w, ci, device="cuda")
    wt = (torch.rand(3, 3, ci, co, device="cuda") - 0.5) * (2 / (9 * ci) ** 0.5)
    b = torch.rand(co, device="cuda") - 0.5
    y = torch.empty(n, h, w, co, device="cuda")
    plan = ring_plan(t, n, h, w, co, torch.cuda.get_device_properties(0).multi_processor_count)
    lib = _build.library()

    def call():
        _build.check(lib.cd_conv3x3_reflect(
            x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(), None, None, 0, 0,
            n, h, w, ci, co, int(relu), t, plan.grid[0],
            torch.cuda.current_stream().cuda_stream), f"template {t}")
    call()
    ref = kc.conv3x3_reflect.plain(x, wt, b, relu)
    scale = float(x.abs().max() * wt.abs().sum(dim=(0, 1, 2)).max() + b.abs().max())
    err = float((y - ref).abs().max()) / scale
    if not err <= chip_smoke.CONV_TOL:
        raise AssertionError(f"template {t} at {shape}: error {err} > {chip_smoke.CONV_TOL}")
    return call, err


def launch_plans(kernel):
    """shape -> the name of the template the checkout's launch plan picks
    for ``kernel`` (None where the kernel has no plan; "first" for a
    checkout whose plan predates the kernel's)."""
    from collaborative_distillation_tpu_torch.ops.cuda import conv
    if kernel.removesuffix("_bf16") in FUSED:
        fuse = "pool" if kernel.startswith("conv3x3_pool") else "up"
        if not hasattr(conv, "FUSES"):   # a checkout before the fused convs: the conv's own
            return launch_plans("conv3x3_reflect" + kernel[len(kernel.removesuffix("_bf16")):])
        if kernel.endswith("_bf16"):
            return lambda s: conv.device_plan_bf16(*s[:5], 0, 9, fuse).kernel
        return lambda s: conv.device_plan(*s[:5], 0, fuse).kernel
    if kernel == "conv3x3_reflect":
        return lambda s: conv.device_plan(*s[:5], 0).kernel if hasattr(conv, "device_plan") \
            else "first"
    plan = getattr(conv, "device_plan_bf16", None)
    if kernel in ("conv3x3_reflect_bf16", "conv1x1_bias_bf16"):
        taps = 9 if kernel.startswith("conv3x3") else 1
        return lambda s: plan(*s[:5], 0, taps=taps).kernel if plan else "first"
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", required=True,
                    choices=("sum_gram", "conv1x1_bias", "conv3x3_reflect",
                             "conv3x3_reflect_bf16", "conv1x1_bias_bf16", *FUSED,
                             *(k + "_bf16" for k in FUSED)))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reference", action="store_true",
                    help="also time the plain version and the library call")
    ap.add_argument("--paths", nargs="+", default=list(PATHS), choices=PATHS + TEACHER_PATHS)
    ap.add_argument("--template", type=int, nargs="+", default=[],
                    help="conv3x3: also time these ring template ids at every shape")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = chip_smoke
    spec.loader.exec_module(chip_smoke)
    # the shapes from this checkout's plans (its route decides what fuses),
    # then the port of ``root`` for everything timed
    sys.path.insert(0, HERE)
    shapes = path_shapes(chip_smoke, args.kernel)
    sys.path.remove(HERE)
    for m in [m for m in sys.modules if m.startswith("collaborative_distillation_tpu_torch")]:
        del sys.modules[m]
    sys.path.insert(0, root)
    from collaborative_distillation_tpu_torch.ops import cuda as kc
    from collaborative_distillation_tpu_torch.utils.flops import card_peak_flops
    chip_smoke.PEAK_FP32_FLOPS = card_peak_flops(0, "float32")[0]   # as chip_smoke.main sets it
    chip_smoke.PEAK_BF16_FLOPS = card_peak_flops(0, "bfloat16")[0]
    bf16 = args.kernel.endswith("_bf16")
    peak = chip_smoke.PEAK_BF16_FLOPS if bf16 else chip_smoke.PEAK_FP32_FLOPS
    f32_name = args.kernel.removesuffix("_bf16")
    plan_of = launch_plans(args.kernel)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    bench = chip_smoke.Bench(torch, None)
    rows = {}
    for path in args.paths:
        sequence = not hasattr(kc, args.kernel)   # a fused conv this checkout lacks
        keys = ("ms", "device_ms", "bound_ms") + (
            ("plain_ms", "library_ms", "copy_ms") if args.reference and not sequence else ()) + (
            ("pair_ms",) if args.reference and f32_name in FUSED and not sequence else ()) + (
            ("library_conv_ms",) if args.reference and args.kernel == "conv3x3_reflect_bf16"
            else ()) + tuple(f"t{t}_ms" for t in args.template)
        tot = dict.fromkeys(keys, 0.0)
        tot["launches"] = 0
        for shape, n in sorted(shapes[path].items(), key=str):
            if shape not in rows:
                with torch.no_grad():
                    chk = ({"max_rel_err": None} if sequence else
                           bench.run(args.kernel, shape, timed=args.reference, reps=REPS))
                    call = make_call(torch, kc, args.kernel, shape)
                    r = {"ms": chip_smoke.cuda_ms(torch, call, REPS)}
                    by = device_ms(torch, call, REPS)
                    del call
                nbytes, flops = chip_smoke.work(f32_name, shape, 2 if bf16 else 4)
                bytes_ms = nbytes / chip_smoke.PEAK_BYTES * 1e3
                flops_ms = flops / peak * 1e3
                r.update(device_ms=sum(by.values()), bound_ms=max(bytes_ms, flops_ms),
                         bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                         max_rel_err=chk["max_rel_err"], by_kernel_ms=by, sequence=sequence)
                if args.reference and not sequence:
                    r.update({k: chk[k] for k in ("plain_ms", "library_ms", "library_conv_ms",
                                                  "pair_ms") if k in chk})
                    src = torch.empty(nbytes // 8, device="cuda")
                    dst = torch.empty_like(src)
                    r["copy_ms"] = chip_smoke.cuda_ms(torch, lambda: dst.copy_(src), REPS)
                    del src, dst
                if plan_of is not None:
                    r["plan"] = plan_of(shape)
                for t in args.template:
                    with torch.no_grad():
                        got = template_call(torch, chip_smoke, kc, t, shape)
                        if got is None:
                            r[f"t{t}_ms"] = float("nan")
                            continue
                        r[f"t{t}_ms"] = chip_smoke.cuda_ms(torch, got[0], REPS)
                        r[f"t{t}_max_rel_err"] = got[1]
                        del got
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
