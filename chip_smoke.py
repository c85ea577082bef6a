#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one GPU and hold every kernel against
its plain PyTorch version.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card, the versions, and the build of the CUDA kernels from
     ``collaborative_distillation_tpu_torch/ops/cuda/csrc``;
  2. each kernel against its plain version on the card, at every distinct
     shape of the mode-16x cascade at 512^2 and 2048^2, plus edge shapes
     (1-pixel maps, odd sizes, C not a multiple of 4); the 2048^2 stage-1
     covariance against a float64 centred covariance;
  3. the main path: ``WCTEngine(mode="16x").stylize`` on a 2048^2 photo pair,
     with every launch counter set to 0 before it and read after it; the
     counts must equal what the cascade's specs predict;
  4. the card's 512^2 output against the same engine on the CPU (PSNR);
  5. timings: each kernel, its plain version and one library call at every
     2048^2 shape of the path, weighted by the calls per cascade, beside the
     least time the card could take; the warm 2048^2 cascade and its stages.

Prints the kernel table as one JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Per-shape details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12      # FP32 outside the tensor cores: FFMA kernels
PEAK_BYTES = 3.35e12         # HBM3
REPO_PATH = "collaborative_distillation_tpu_torch/ops/cuda/csrc/"
KERNEL_META = {
    "conv3x3_reflect": ("conv3x3.cu", "collaborative_distillation_tpu/ops/pallas/conv.py:754"),
    "sum_gram": ("sum_gram.cu", "collaborative_distillation_tpu/ops/pallas/stats.py:61"),
    "max_pool_2x2": ("pool.cu", "collaborative_distillation_tpu/ops/pallas/pool.py:96"),
    "upsample_nearest_2x": ("pool.cu", "collaborative_distillation_tpu/ops/pallas/pool.py:141"),
}
# Tolerances, each against the plain version on the same inputs:
#   conv3x3: |kernel - plain| <= 1e-5 * S, S = max|x| * max_co sum|w| + max|b|,
#     the largest magnitude any partial sum can take; both sum up to 4608
#     float32 products in different orders (typical error ~sqrt(K) eps S).
#   sum_gram: |G_k - G_p| <= 2e-5 * max|G_p| and |S_k - S_p| <= 2e-5 * sum|x - s|;
#     float32 sums over up to 4M rows in different orders.
#   covariance at the 2048^2 stage-1 map vs float64 centred: 1e-4 * max|cov64|.
#   pool, upsample: exact (a max and a copy).
CONV_TOL = 1e-5
GRAM_TOL = 2e-5
COV64_TOL = 1e-4
PSNR_MIN_DB = 40.0


def log(*a):
    print(*a, flush=True)


def path_calls(pyramid, stages, h, w):
    """Kernel calls of one cascade on an (h, w) content and style of the same
    size: {(kernel, shape): count}, plus {shape: (stage, part, layer)} naming
    the first layer that runs each conv shape."""
    calls, layer_of = Counter(), {}
    for k in stages:
        es, ds = pyramid[k]["enc_spec"], pyramid[k]["dec_spec"]
        for _ in ("style", "content"):
            hh, ww = h, w
            for l in es.layers:
                shape = (1, hh, ww, l.in_ch, l.out_ch, l.relu)
                calls[("conv3x3_reflect", shape)] += 1
                layer_of.setdefault(shape, (k, "enc", l.name))
                if l.pool_after:
                    calls[("max_pool_2x2", (1, hh, ww, l.out_ch))] += 1
                    hh, ww = hh // 2, ww // 2
            calls[("sum_gram", (hh * ww, es.out_channels))] += 1
        last = ds.layers[-1]
        for l in ds.layers:
            shape = (1, hh, ww, l.in_ch, l.out_ch, l.relu)
            calls[("conv3x3_reflect", shape)] += 1
            layer_of.setdefault(shape, (k, "dec", l.name))
            if l.unpool_after:
                calls[("upsample_nearest_2x", (1, hh, ww, l.out_ch))] += 1
                hh, ww = hh * 2, ww * 2
        assert last.out_ch == 3 and (hh, ww) == (h, w)
    return calls, layer_of


def work(kernel, shape):
    """(bytes, flops) the function must move and compute: each input read
    once, each output written once, float32."""
    if kernel == "conv3x3_reflect":
        n, h, w, ci, co, _ = shape
        px = n * h * w
        return 4 * (px * ci + 9 * ci * co + co + px * co), 2 * 9 * ci * co * px
    if kernel == "sum_gram":
        # X^T X is symmetric: c(c+1)/2 distinct entries, a multiply and an add
        # each per row; the column sum and the shift subtraction p*c each
        p, c = shape
        return 4 * (p * c + c + c * c + c), p * c * (c + 1) + 2 * p * c
    n, h, w, c = shape
    if kernel == "max_pool_2x2":
        out = n * (h // 2) * (w // 2) * c
        return 4 * (n * h * w * c + out), 3 * out
    return 4 * (n * h * w * c * 5), 0


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls after two warm-ups,
    timed with CUDA events."""
    for _ in range(2):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


class Bench:
    """Builds inputs for one kernel at one shape, compares the kernel with
    its plain version and, with ``timed``, times kernel, plain and library."""

    def __init__(self, torch, pyramid):
        self.torch = torch
        self.F = torch.nn.functional
        self.pyramid = pyramid
        self.gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(self, *shape):
        return self.torch.rand(shape, generator=self.gen, device="cuda")

    def run(self, kernel, shape, layer=None, timed=False, reps=10):
        with self.torch.no_grad():
            return self._run(kernel, shape, layer, timed, reps)

    def _run(self, kernel, shape, layer, timed, reps):
        torch, F = self.torch, self.F
        from collaborative_distillation_tpu_torch.ops import cuda as kc
        k = getattr(kc, kernel)
        row = {"kernel": kernel, "shape": list(shape)}
        if kernel == "conv3x3_reflect":
            n, h, w, ci, co, relu = shape
            x = self.rand(n, h, w, ci)
            if layer is not None:
                stage, part, name = layer
                p = self.pyramid[stage][part][name]
                wt, b = p["w"].contiguous(), p["b"].contiguous()
            else:
                wt = (self.rand(3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)
                b = self.rand(co) - 0.5
            got, ref = k(x, wt, b, relu), k.plain(x, wt, b, relu)
            scale = float(x.abs().max() * wt.abs().sum(dim=(0, 1, 2)).max() + b.abs().max())
            err = float((got - ref).abs().max())
            tol = CONV_TOL * scale
            call = lambda: k(x, wt, b, relu)
            plain = lambda: k.plain(x, wt, b, relu)
            if timed:
                lib = torch.nn.Conv2d(ci, co, 3, padding=1, padding_mode="reflect",
                                      device="cuda")
                with torch.no_grad():
                    lib.weight.copy_(wt.permute(3, 2, 0, 1))
                    lib.bias.copy_(b)
                xn = x.permute(0, 3, 1, 2)  # NHWC memory as a channels-last NCHW view
                library = lambda: lib(xn)
        elif kernel == "sum_gram":
            p, c = shape
            x = self.rand(p, c) * 4 + 10   # mean far above the spread, as features are
            shift = x[:4096].mean(0)
            (sk, gk), (sp, gp) = k(x, shift), k.plain(x, shift)
            gerr, serr = float((gk - gp).abs().max()), float((sk - sp).abs().max())
            err = max(gerr, serr)
            scale = float(gp.abs().max())
            tol = GRAM_TOL * scale
            ok = gerr <= tol and serr <= GRAM_TOL * float((x - shift).abs().sum(0).max())
            call = lambda: k(x, shift)
            plain = lambda: k.plain(x, shift)
            library = lambda: x.T @ x
        else:
            n, h, w, c = shape
            x = self.rand(n, h, w, c)
            got, ref = k(x), k.plain(x)
            err = float((got - ref).abs().max()) if ref.numel() else 0.0
            if got.shape != ref.shape:
                raise AssertionError(f"{kernel}{shape}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
            tol, scale = 0.0, 1.0
            call = lambda: k(x)
            plain = lambda: k.plain(x)
            xn = x.permute(0, 3, 1, 2)
            library = ((lambda: F.max_pool2d(xn, 2)) if kernel == "max_pool_2x2"
                       else (lambda: F.interpolate(xn, scale_factor=2, mode="nearest")))
        if kernel != "sum_gram":
            ok = err <= tol
        torch.cuda.synchronize()
        row.update(max_abs_err=err, max_rel_err=err / max(scale, 1e-30), tol=tol, ok=ok)
        if not ok:
            raise AssertionError(f"{kernel}{shape}: kernel vs plain error {err} > {tol}")
        if timed:
            nbytes, flops = work(kernel, shape)
            row.update(ms=cuda_ms(torch, call, reps), plain_ms=cuda_ms(torch, plain, reps),
                       library_ms=cuda_ms(torch, library, reps),
                       bytes_ms=nbytes / PEAK_BYTES * 1e3, flops_ms=flops / PEAK_FP32_FLOPS * 1e3)
        return row


def profile_cascade(torch, eng, img, sty) -> dict:
    """One warm cascade under torch.profiler: device time by kernel name, and
    the card's idle share of that same cascade, 1 - busy / span, with the
    span taken by CUDA events around it (profiler on in both)."""
    from torch.profiler import ProfilerActivity, profile
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        eng.stylize_device(img, sty)
        b.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    span_ms = a.elapsed_time(b)
    kernels = Counter()
    calls = Counter()
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            ms = getattr(e, "self_device_time_total", 0.0) / 1e3
            if ms > 0:
                kernels[e.key[:90]] += ms
                calls[e.key[:90]] += e.count
    busy = sum(kernels.values())
    if busy == 0:
        log("phase 5: profiler saw no device time: breakdown not measured")
        return {"wall_ms": wall_ms, "span_ms": span_ms, "busy_ms": None}
    top = kernels.most_common(12)
    log(f"phase 5: profiled cascade wall {wall_ms:.2f} ms, event span {span_ms:.2f} ms, "
        f"device busy {busy:.2f} ms, idle share {1 - busy / span_ms:.3f}; top device time:")
    for name, ms in top:
        log(f"    {ms:8.3f} ms  x{calls[name]:<4d} {name}")
    return {"wall_ms": wall_ms, "span_ms": span_ms, "busy_ms": busy,
            "idle_share": 1 - busy / span_ms,
            "by_kernel_ms": dict(top), "calls": {n: calls[n] for n, _ in top}}


def reflect_tile(torch, img_u8: np.ndarray, size: int) -> np.ndarray:
    """Reflect-tile an (H, W, 3) image up to (size, size, 3) on the card."""
    from collaborative_distillation_tpu_torch.ops.pad import reflect_index
    x = torch.from_numpy(img_u8).cuda()
    h, w, _ = x.shape
    x = x.index_select(0, reflect_index(h, 0, size - h, x.device))
    x = x.index_select(1, reflect_index(w, 0, size - w, x.device))
    return x.cpu().numpy()


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from collaborative_distillation_tpu_torch.ops import cuda as kc
    from collaborative_distillation_tpu_torch.ops.cuda import _build
    from collaborative_distillation_tpu_torch.ops.wct_transform import feature_stats
    from collaborative_distillation_tpu_torch.models.vgg import apply_decoder, apply_encoder
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine, stylize_stage

    detail: dict = {}
    # ---- phase 1: card, versions, build ------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(built={_build.last_build['built']}, {_build.last_build['dir']})")
    for line in _build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())
    detail["card"] = smi
    detail["build_s"] = _build.last_build["seconds"]

    with np.load(os.path.join(HERE, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c512, s512 = d["content"], d["style"]
    c2k, s2k = reflect_tile(torch, c512, 2048), reflect_tile(torch, s512, 2048)

    eng = WCTEngine(mode="16x")   # default device: the card
    pyr = eng.pyramid
    bench = Bench(torch, pyr)

    # ---- phase 2: kernel vs plain at the path's shapes ---------------------
    calls512, layers512 = path_calls(pyr, eng.stages, 512, 512)
    calls2k, layers2k = path_calls(pyr, eng.stages, 2048, 2048)
    checks = []
    for (kernel, shape) in sorted(calls512, key=str):
        checks.append(bench.run(kernel, shape, layers512.get(shape)))
    edge = [("conv3x3_reflect", s) for s in
            [(1, 1, 1, 128, 128, True), (1, 1, 1, 3, 24, True), (1, 1, 7, 64, 64, True),
             (1, 5, 1, 16, 32, False), (2, 3, 5, 24, 3, True), (1, 17, 33, 3, 16, True),
             (1, 16, 16, 512, 512, True), (1, 9, 9, 128, 3, False)]]
    edge += [("max_pool_2x2", s) for s in [(1, 7, 9, 16), (2, 8, 8, 3), (1, 1, 5, 8)]]
    edge += [("upsample_nearest_2x", s) for s in [(1, 3, 5, 16), (2, 4, 4, 3)]]
    edge += [("sum_gram", s) for s in [(1000, 24), (777, 128), (5000, 512), (1, 3)]]
    for kernel, shape in edge:
        checks.append(bench.run(kernel, shape))
    log(f"phase 2: {len(checks)} kernel-vs-plain checks passed at 512^2 path and edge shapes")
    # 1-pixel reflect: a 16x16 image reaches conv51 at 1x1 in the stage-5
    # encoder; every stage's encoder and decoder, card vs CPU plain
    tiny = np.random.default_rng(0).random((1, 16, 16, 3), np.float32)
    eng_cpu = WCTEngine(mode="16x", device="cpu")
    worst = 0.0
    with torch.inference_mode():
        for k in eng.stages:
            p, q = pyr[k], eng_cpu.pyramid[k]
            rec = {}
            for e, dev in ((p, "cuda"), (q, "cpu")):
                f = apply_encoder(e["enc"], torch.from_numpy(tiny).to(dev), e["enc_spec"])["out"]
                rec[dev] = apply_decoder(e["dec"], f, e["dec_spec"])["out"].cpu()
            scale = float(rec["cpu"].abs().max()) + 1e-6
            worst = max(worst, float((rec["cuda"] - rec["cpu"]).abs().max()) / scale)
    log(f"phase 2: 16x16 encoder+decoder, stages {eng.stages} (conv51 at 1x1), "
        f"card vs cpu max rel err {worst:.3e}")
    if not worst <= 1e-4:
        raise AssertionError(f"16x16 encoder/decoder card vs cpu rel err {worst}")

    # stage-1 2048^2 covariance: shifted kernel Gram vs float64 centred
    with torch.inference_mode():
        s1 = eng._prep(c2k)
        feats = apply_encoder(pyr[1]["enc"], s1, pyr[1]["enc_spec"], aux=False)["out"]
        x = feats.reshape(-1, feats.shape[-1])
        mean, cov = feature_stats(feats)
        x64 = x.double()
        m64 = x64.mean(0)
        cov64 = ((x64 - m64).T @ (x64 - m64)) / (x.shape[0] - 1)
        s_raw, g_raw = kc.sum_gram(x.contiguous())          # unshifted, as fused_sum_gram
        p = x.shape[0]
        cov_raw = (g_raw - p * torch.outer(s_raw / p, s_raw / p)) / (p - 1)
        scale = float(cov64.abs().max())
        cov_err = float((cov.double() - cov64).abs().max()) / scale
        raw_err = float((cov_raw.double() - cov64).abs().max()) / scale
        mean_err = float((mean.double() - m64).abs().max() / m64.abs().max())
    log(f"phase 2: stage-1 2048^2 covariance ({p} x {x.shape[1]}) vs float64 centred: "
        f"shifted kernel rel err {cov_err:.3e} (tol {COV64_TOL}), unshifted "
        f"{raw_err:.3e}; mean rel err {mean_err:.3e}")
    detail["cov64"] = {"shifted_rel_err": cov_err, "unshifted_rel_err": raw_err,
                       "mean_rel_err": mean_err}
    if not cov_err <= COV64_TOL:
        raise AssertionError(f"stage-1 covariance rel err {cov_err} > {COV64_TOL}")
    del s1, feats, x, x64, cov64

    # ---- phase 3: the main path at 2048^2 ----------------------------------
    for k in kc.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = eng.stylize(c2k, s2k, alpha=1.0)
    main_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kc.KERNELS}
    expect = Counter()
    for (kernel, _), n in calls2k.items():
        expect[kernel] += n
    log(f"phase 3: stylize 2048^2 in {main_s:.3f} s (first call, host transfer "
        f"included); launches {launches}, predicted {dict(expect)}")
    if any(launches[k] <= 0 for k in launches) or launches != dict(expect):
        raise AssertionError(f"launch counts {launches} != predicted {dict(expect)}")
    content_f = c2k.astype(np.float32) / 255.0
    change = float(np.abs(out - content_f).mean())
    if not (out.shape == c2k.shape and np.isfinite(out).all()
            and out.min() >= 0.0 and out.max() <= 1.0 and change > 0.02):
        raise AssertionError(f"bad 2048^2 output: shape {out.shape}, range "
                             f"[{out.min()}, {out.max()}], mean change {change}")
    log(f"phase 3: output finite, in [0, 1], mean |out - content| {change:.4f}")

    # ---- phase 4: 512^2 card vs CPU plain cascade ---------------------------
    o_card = eng.stylize(c512, s512)
    o_cpu = eng_cpu.stylize(c512, s512)
    db = psnr(o_card, o_cpu)
    log(f"phase 4: 512^2 card vs cpu PSNR {db:.2f} dB (min {PSNR_MIN_DB})")
    detail["psnr_512_card_vs_cpu_db"] = db
    if not db >= PSNR_MIN_DB:
        raise AssertionError(f"512^2 card vs cpu PSNR {db:.2f} dB < {PSNR_MIN_DB}")

    # ---- phase 5: timings at the 2048^2 path shapes -------------------------
    rows = []
    for (kernel, shape), n in sorted(calls2k.items(), key=str):
        r = bench.run(kernel, shape, layers2k.get(shape), timed=True)
        r["calls"] = n
        rows.append(r)
    table = []
    for k in kc.KERNELS:
        name = k.__name__
        mine = [r for r in rows if r["kernel"] == name]
        tot = lambda key: sum(r[key] * r["calls"] for r in mine)
        # each shape is bound by the larger of its two times; the row is
        # labelled by the side that sets most of the summed bound
        by_bytes = sum(r["bytes_ms"] * r["calls"] for r in mine
                       if r["bytes_ms"] >= r["flops_ms"])
        by_ops = sum(r["flops_ms"] * r["calls"] for r in mine
                     if r["bytes_ms"] < r["flops_ms"])
        bound = by_bytes + by_ops
        src, rep = KERNEL_META[name]
        errs = [r["max_abs_err"] for r in checks + rows if r["kernel"] == name]
        rel = [r["max_rel_err"] for r in checks + rows if r["kernel"] == name]
        table.append({
            "name": name, "route": "cuda", "source": REPO_PATH + src, "replaces": rep,
            "launches": launches[name], "max_abs_err": max(errs), "max_err": max(errs),
            "max_rel_err": max(rel),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes_ms": by_bytes, "bound_ops_ms": by_ops,
            "library_ms": tot("library_ms")})
    detail["shapes_2048"] = rows
    detail["checks"] = checks

    # warm cascade: median of 5, and one run split by stage
    with torch.inference_mode():
        img, sty = eng._prep(c2k), eng._prep(s2k)
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.stylize_device(img, sty)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        stage_ms = {}
        alpha = torch.tensor(1.0, device="cuda")
        x = img
        for k in eng.stages:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            sm, sc = eng._style_stats(k, sty)
            p = pyr[k]
            x = stylize_stage(p["enc"], p["dec"], p["enc_spec"], p["dec_spec"], x,
                              sm, sc, alpha, eng.method)
            b.record()
            torch.cuda.synchronize()
            stage_ms[k] = a.elapsed_time(b)
        peak = torch.cuda.max_memory_allocated() / 2**30
    detail["cascade_2048_ms"] = {"runs": runs, "median": statistics.median(runs),
                                 "stages": stage_ms, "peak_gib": peak}
    log(f"phase 5: 2048^2 cascade warm {statistics.median(runs):.2f} ms "
        f"(runs {', '.join(f'{r:.2f}' for r in runs)}), peak {peak:.2f} GiB; stages "
        + ", ".join(f"{k}: {v:.2f} ms" for k, v in stage_ms.items()))
    detail["profile_2048"] = profile_cascade(torch, eng, img, sty)
    for r in table:
        log(f"  {r['name']}: {r['ms']:.3f} ms/cascade over {r['launches']} launches, "
            f"plain {r['plain_ms']:.3f}, library {r['library_ms']:.3f}, "
            f"bound {r['bound_ms']:.3f} ({r['bound_by']}), max abs err {r['max_abs_err']:.3e}, "
            f"max rel err {r['max_rel_err']:.3e}")

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    detail["kernels"] = table
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
