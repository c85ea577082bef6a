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
     shape of the mode-16x cascade at 512^2 and of the UHD slab cascade,
     the plain UHD cascade's largest conv map, plus edge shapes (1-pixel maps, odd sizes, C not a multiple of 4,
     unaligned slices); ``halo_exchange_rows`` exactly, at every (stage,
     shard position) shape of the sharded UHD path and at edge shapes (one
     row, the whole neighbour, N = 2, odd row sizes, offset slices, the
     shard's own reflection rows as sources); a 16x16 image (relu5_1 at 1x1) stylizes to all-NaN
     without raising, as the reference does; the 2048^2 and the UHD
     (slab-summed) stage-1 covariances against float64 centred ones;
  3. the main path: ``WCTEngine(mode="16x").stylize`` on a 2048^2 photo pair,
     with every launch counter set to 0 before it and read after it; the
     counts must equal what the cascade's specs predict;
  3b. the UHD path: ``WCTEngine(mode="16x", slab_rows=1024).stylize`` on the
     photo pair reflect-tiled to 4096 x 10240 content and 2048^2 style, one
     warm cascade with the counters zeroed; the counts must equal the slab
     plan's (20 ``conv1x1_bias`` launches: 5 stages x 4 slabs);
  3c. the sharded UHD path: ``WCTEngine(mode="16x", space=4, slab_rows=512,
     devices=["cuda:0"] * 4).stylize`` on the same pair, four row shards on
     the one card, counters zeroed; the counts must equal the sharded plan's
     (20 ``halo_exchange_rows`` launches: 5 stages x 4 shards). With two or
     more cards the halo check and this phase run once more across cards;
     with one a line says that no cross-card run was made;
  4. the card's 512^2 output against the same engine on the CPU (PSNR);
  4b. the UHD slab output against the plain per-stage cascade on the card
     (PSNR), a 2048^2 slab run (``slab_rows=512``) against the plain one,
     and the feature cache on against off;
  4c. the sharded UHD output against the single-card fused slab cascade at
     the same slab size (PSNR), and the per-conv sharded cascade at 2048^2
     (``space=4`` without ``slab_rows``) against the plain one;
  4d. a height that is no slab multiple (4000 x 10240): the slab cascade
     against the plain one, and the sharded cascade against the slab one
     (PSNR; the last window ends at the image, nothing is mirrored in);
  5. timings: each kernel, its plain version and one library call at every
     2048^2 shape of the path, weighted by the calls per cascade, beside the
     least time the card could take; the warm 2048^2 cascade and its stages;
  5b. the same for ``conv1x1_bias`` and ``sum_gram`` at the UHD slab shapes
     (``sum_gram``'s as a second summary on its row); the warm UHD
     slab cascade (median of 3), split by stage and into pass 1 and pass 2,
     its peak memory and profile; ``stylize(as_uint8=True)`` host to host
     with the streamed last stage against without, three runs each, both
     with the slab plan's launch counts;
  5c. ``halo_exchange_rows`` at the sharded UHD shapes beside its plain
     version and ``torch.cat`` of ready slices; the warm sharded UHD cascade
     (median of 3), its peak memory and profile;
  6. the host boundary: (a) whether the native codec built (or why not);
     with it, ``stylize_jpeg`` on a UHD 4:2:0 JPEG made from the photo pair,
     with the counters zeroed (the slab plan's counts), its bytes and
     ``stylize_planes_jpeg``'s equal to ``stylize_planes`` +
     ``encode_jpeg_yuv420``; without it, the None contract; (b)
     ``stylize_planes`` at UHD against the RGB transport (Y plane PSNR); (c)
     uint8 host-to-host walls at 2048^2 and UHD for ``transport="rgb"`` and
     ``"yuv420"``, and ``push`` through pinned staging at several chunk sizes
     against a pageable ``.to()``; (d) ``stylize_pairs`` over four 2048^2
     uint8 pairs, bit-equal to four ``stylize`` calls, and both walls.

With ``--cross-card`` (two or more cards) it runs only the halo check and
the sharded UHD path with neighbouring shards on different cards, against
the single-card slab cascade, and prints no kernel table.

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
    "conv1x1_bias": ("conv1x1.cu", "collaborative_distillation_tpu/ops/pallas/conv.py:437"),
    "sum_gram": ("sum_gram.cu", "collaborative_distillation_tpu/ops/pallas/stats.py:61"),
    "max_pool_2x2": ("pool.cu", "collaborative_distillation_tpu/ops/pallas/pool.py:96"),
    "upsample_nearest_2x": ("pool.cu", "collaborative_distillation_tpu/ops/pallas/pool.py:141"),
    "halo_exchange_rows": ("halo.cu", "collaborative_distillation_tpu/ops/pallas/halo.py:148"),
}
KERNEL_PATH = {"conv1x1_bias": "UHD slab", "halo_exchange_rows": "UHD sharded"}
# Tolerances, each against the plain version on the same inputs:
#   conv3x3, conv1x1: |kernel - plain| <= 1e-5 * S, S = max|x| * max_co sum|w|
#     + max|b|, the largest magnitude any partial sum can take; both sum up
#     to 4608 (3x3) or 128 (1x1) float32 products in different orders
#     (typical error ~sqrt(K) eps S).
#   sum_gram: |G_k - G_p| <= 2e-5 * max|G_p| and |S_k - S_p| <= 2e-5 * sum|x - s|;
#     float32 sums over up to 4M rows in different orders.
#   covariance at the 2048^2 and UHD stage-1 maps vs float64 centred:
#     1e-4 * max|cov64|.
#   feature cache on vs off: 1e-6 (the same kernels on the same inputs).
#   pool, upsample, halo_exchange_rows: exact (a max and copies).
CONV_TOL = 1e-5
GRAM_TOL = 2e-5
COV64_TOL = 1e-4
PSNR_MIN_DB = 40.0
CACHE_TOL = 1e-6
UHD_H, UHD_W = 4096, 10240   # the README's 10240x4096 UHD image, rows first
UHD_SLAB = 1024
SHARDS = 4                   # row shards of the sharded UHD path
SHARD_SLAB = 512             # two slabs in each 1024-row shard
AWK_H = 4000                 # phase 4d: no multiple of either slab size
PUSH_CHUNKS = (4 << 20, 16 << 20, 64 << 20)   # phase 6c: push's staging chunks


def log(*a):
    print(*a, flush=True)


def _encoder_calls(calls, layer_of, k, spec, hh, ww):
    """Add one encoder run on an (hh, ww) map; returns its output size."""
    for l in spec.layers:
        shape = (1, hh, ww, l.in_ch, l.out_ch, l.relu)
        calls[("conv3x3_reflect", shape)] += 1
        layer_of.setdefault(shape, (k, "enc", l.name))
        if l.pool_after:
            calls[("max_pool_2x2", (1, hh, ww, l.out_ch))] += 1
            hh, ww = hh // 2, ww // 2
    return hh, ww


def _decoder_calls(calls, layer_of, k, spec, hh, ww):
    """Add one decoder run on an (hh, ww) map; returns its output size."""
    for l in spec.layers:
        shape = (1, hh, ww, l.in_ch, l.out_ch, l.relu)
        calls[("conv3x3_reflect", shape)] += 1
        layer_of.setdefault(shape, (k, "dec", l.name))
        if l.unpool_after:
            calls[("upsample_nearest_2x", (1, hh, ww, l.out_ch))] += 1
            hh, ww = hh * 2, ww * 2
    assert spec.layers[-1].out_ch == 3
    return hh, ww


def path_calls(pyramid, stages, h, w):
    """Kernel calls of one cascade on an (h, w) content and style of the same
    size: {(kernel, shape): count}, plus {shape: (stage, part, layer)} naming
    the first layer that runs each conv shape."""
    calls, layer_of = Counter(), {}
    for k in stages:
        es, ds = pyramid[k]["enc_spec"], pyramid[k]["dec_spec"]
        for _ in ("style", "content"):
            hh, ww = _encoder_calls(calls, layer_of, k, es, h, w)
            calls[("sum_gram", (hh * ww, es.out_channels))] += 1
        assert _decoder_calls(calls, layer_of, k, ds, hh, ww) == (h, w)
    return calls, layer_of


def slab_path_calls(pyramid, stages, margins, slab, h, w, sh, sw, cache_bytes):
    """Kernel calls of one fused slab cascade (no style key: the style is
    encoded whole at every stage) on an (h, w) content, h a multiple of
    ``slab``, and an (sh, sw) style, from the stage margins: per stage, pass
    1 encodes every extended slab and sums its interior feature rows; pass
    2 re-encodes unless the stage's stacked features fit in ``cache_bytes``,
    applies the folded WCT (``conv1x1_bias``) and decodes."""
    calls, layer_of = Counter(), {}
    n_slabs = h // slab
    for k in stages:
        es, ds = pyramid[k]["enc_spec"], pyramid[k]["dec_spec"]
        c, down = es.out_channels, 2 ** (k - 1)
        hh, ww = _encoder_calls(calls, layer_of, k, es, sh, sw)
        calls[("sum_gram", (hh * ww, c))] += 1
        rows = slab + 2 * margins[k] if n_slabs > 1 else h
        cache = n_slabs * (rows // down) * (w // down) * c * 4 <= cache_bytes
        for _ in range(n_slabs):
            fh, fw = _encoder_calls(calls, layer_of, k, es, rows, w)
            calls[("sum_gram", (slab // down * fw, c))] += 1
        for _ in range(n_slabs):
            if not cache:
                _encoder_calls(calls, layer_of, k, es, rows, w)
            calls[("conv1x1_bias", (1, fh, fw, c, c, False, True, 0))] += 1
            assert _decoder_calls(calls, layer_of, k, ds, fh, fw) == (rows, w)
    return calls, layer_of


def sharded_path_calls(pyramid, stages, margins, slab, space, h, w, sh, sw):
    """Kernel calls of one sharded slab cascade (no style key) on an (h, w)
    content cut into ``space`` row shards of a multiple of ``slab`` rows,
    and an (sh, sw) style: per stage the style's encode and statistics on
    the engine's device, one halo exchange per shard (2 * margin rows from
    each neighbour), then per shard pass 1 over its slabs of ``slab + 2 *
    margin`` rows and pass 2, which encodes each slab again."""
    calls, layer_of = Counter(), {}
    h_loc = h // space
    n_slabs = h_loc // slab
    for k in stages:
        es, ds = pyramid[k]["enc_spec"], pyramid[k]["dec_spec"]
        c, down = es.out_channels, 2 ** (k - 1)
        hh, ww = _encoder_calls(calls, layer_of, k, es, sh, sw)
        calls[("sum_gram", (hh * ww, c))] += 1
        hm = 2 * margins[k]
        rows = slab + hm
        for d in range(space):
            pos = "first" if d == 0 else "last" if d == space - 1 else "mid"
            calls[("halo_exchange_rows", (1, h_loc, w, 3, hm, pos, 0))] += 1
            for _ in range(n_slabs):
                fh, fw = _encoder_calls(calls, layer_of, k, es, rows, w)
                calls[("sum_gram", (slab // down * fw, c))] += 1
            for _ in range(n_slabs):
                _encoder_calls(calls, layer_of, k, es, rows, w)
                calls[("conv1x1_bias", (1, fh, fw, c, c, False, True, 0))] += 1
                assert _decoder_calls(calls, layer_of, k, ds, fh, fw) == (rows, w)
    return calls, layer_of


def work(kernel, shape):
    """(bytes, flops) the function must move and compute: each input read
    once, each output written once, float32."""
    if kernel == "conv3x3_reflect":
        n, h, w, ci, co, _ = shape
        px = n * h * w
        return 4 * (px * ci + 9 * ci * co + co + px * co), 2 * 9 * ci * co * px
    if kernel == "conv1x1_bias":
        n, h, w, ci, co, _, bias, _ = shape
        px = n * h * w
        return 4 * (px * ci + ci * co + (co if bias else 0) + px * co), 2 * ci * co * px
    if kernel == "sum_gram":
        # X^T X is symmetric: c(c+1)/2 distinct entries, a multiply and an add
        # each per row; the column sum and the shift subtraction p*c each
        p, c = shape[:2]
        return 4 * (p * c + c + c * c + c), p * c * (c + 1) + 2 * p * c
    if kernel == "halo_exchange_rows":
        # the extended map written once; the shard and each halo that has a
        # source read once (a global edge's zero fill reads nothing)
        n, h, w, c, hm, pos, _ = shape
        sources = (pos != "first") + (pos != "last")
        return 4 * n * w * c * ((h + 2 * hm) + (h + sources * hm)), 0
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
        elif kernel == "conv1x1_bias":
            # (N, H, W, Cin, Cout, relu, bias, offset): an offset of a few
            # floats leaves a contiguous map that is not 16-byte aligned
            n, h, w, ci, co, relu, bias, offset = shape
            x = (self.rand(n * h * w * ci + offset) - 0.5)[offset:].view(n, h, w, ci)
            wt = (self.rand(ci, co) - 0.5) * (2 / ci ** 0.5)
            b = self.rand(co) - 0.5 if bias else None
            got, ref = k(x, wt, b, relu), k.plain(x, wt, b, relu)
            scale = float(x.abs().max() * wt.abs().sum(0).max()
                          + (b.abs().max() if bias else 0.0))
            err = float((got - ref).abs().max())
            tol = CONV_TOL * scale
            del got, ref
            call = lambda: k(x, wt, b, relu)
            plain = lambda: k.plain(x, wt, b, relu)
            x2 = x.view(-1, ci)
            library = ((lambda: torch.addmm(b, x2, wt)) if bias
                       else (lambda: torch.mm(x2, wt)))
        elif kernel == "sum_gram":
            # (P, C) or (P, C, float offset): an offset leaves a contiguous
            # matrix that is not 16-byte aligned
            p, c, *rest = shape
            offset = rest[0] if rest else 0
            # mean far above the spread, as features are
            x = (self.rand(p * c + offset) * 4 + 10)[offset:].view(p, c)
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
        elif kernel == "halo_exchange_rows":
            # (N, H, W, C, hm, shard position, float offset): the shard and
            # its neighbours are contiguous maps that start ``offset`` floats
            # into their buffers; the halos are the neighbours' boundary rows
            n, h, w, c, hm, pos, offset = shape
            x, up, down = ((self.rand(n * h * w * c + offset))[offset:].view(n, h, w, c)
                           for _ in range(3))
            top = up[:, -hm:] if pos != "first" else None
            bot = down[:, :hm] if pos != "last" else None
            got, ref = k(x, top, bot, hm), k.plain(x, top, bot, hm)
            if got.shape != ref.shape:
                raise AssertionError(f"{kernel}{shape}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
            err = float((got - ref).abs().max())
            tol, scale = 0.0, 1.0
            del got, ref
            call = lambda: k(x, top, bot, hm)
            plain = lambda: k.plain(x, top, bot, hm)
            zeros = torch.zeros((n, hm, w, c), device="cuda")
            parts = [zeros if top is None else top, x, zeros if bot is None else bot]
            library = lambda: torch.cat(parts, dim=1)
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


def path_times(mine) -> dict:
    """A kernel's timed shapes summed over one cascade, weighted by their
    calls: ms, plain_ms, library_ms and the bound. Each shape is bound by the
    larger of its two times; the sum is labelled by the side that sets most
    of it."""
    tot = lambda key: sum(r[key] * r["calls"] for r in mine)
    by_bytes = sum(r["bytes_ms"] * r["calls"] for r in mine if r["bytes_ms"] >= r["flops_ms"])
    by_ops = sum(r["flops_ms"] * r["calls"] for r in mine if r["bytes_ms"] < r["flops_ms"])
    return {"ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": by_bytes + by_ops,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes_ms": by_bytes, "bound_ops_ms": by_ops,
            "library_ms": tot("library_ms")}


def profile_cascade(torch, eng, img, sty, label="phase 5") -> dict:
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
        log(f"{label}: profiler saw no device time: breakdown not measured")
        return {"wall_ms": wall_ms, "span_ms": span_ms, "busy_ms": None}
    top = kernels.most_common(12)
    # sum_gram's kernels (row or tiled, and the reduce) by their names
    sg = sum(ms for name, ms in kernels.items() if "sum_gram" in name)
    sg_calls = sum(n for name, n in calls.items() if "sum_gram" in name)
    log(f"{label}: profiled cascade wall {wall_ms:.2f} ms, event span {span_ms:.2f} ms, "
        f"device busy {busy:.2f} ms, idle share {1 - busy / span_ms:.3f}; sum_gram "
        f"{sg:.3f} ms over {sg_calls} CUDA launches; top device time:")
    for name, ms in top:
        log(f"    {ms:8.3f} ms  x{calls[name]:<4d} {name}")
    return {"wall_ms": wall_ms, "span_ms": span_ms, "busy_ms": busy,
            "idle_share": 1 - busy / span_ms, "sum_gram_ms": sg,
            "by_kernel_ms": dict(top), "calls": {n: calls[n] for n, _ in top}}


def reflect_tile(torch, img_u8: np.ndarray, size: int, width: int | None = None) -> np.ndarray:
    """Reflect-tile an (H, W, 3) image up to (size, width or size, 3) on the card."""
    from collaborative_distillation_tpu_torch.ops.pad import reflect_index
    x = torch.from_numpy(img_u8).cuda()
    h, w, _ = x.shape
    x = x.index_select(0, reflect_index(h, 0, size - h, x.device))
    x = x.index_select(1, reflect_index(w, 0, (width or size) - w, x.device))
    return x.cpu().numpy()


def psnr_device(torch, a, b) -> float:
    """PSNR of two [0, 1] images on the card, the mean in float64."""
    mse = float(((a.float() - b.float()) ** 2).double().mean())
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def stats64(feats):
    """Float64 centred (mean, cov) of ``feats`` (..., C) on the card."""
    x64 = feats.reshape(-1, feats.shape[-1]).double()
    m64 = x64.mean(0)
    x64 -= m64
    return m64, (x64.T @ x64) / (x64.shape[0] - 1)


def rel_err(got, want) -> float:
    return float((got.double() - want).abs().max()) / float(want.abs().max())


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def sharded_main_path(torch, kc, engine, c_uhd, s2k, calls_sh, label) -> dict:
    """The sharded UHD path through ``engine.stylize``, host to host: one
    warm call, then one with every launch counter set to 0 before it and
    read after it; the counts must equal the sharded plan's and the output
    must be a finite, restyled image in [0, 1]."""
    t0 = time.perf_counter()
    engine.stylize(c_uhd, s2k)   # warm
    cold = time.perf_counter() - t0
    for k in kc.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = engine.stylize(c_uhd, s2k, alpha=1.0)
    secs = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in kc.KERNELS}
    expect = {k.__name__: sum(c for (kernel, _), c in calls_sh.items()
                              if kernel == k.__name__) for k in kc.KERNELS}
    log(f"{label}: stylize {UHD_H}x{UHD_W} space={SHARDS} slab_rows={engine._tiled_slab} "
        f"on {[str(d) for d in engine.mesh.devices[0]]} in {secs:.3f} s warm "
        f"({cold:.3f} s first call; host transfer included); launches {counts}, "
        f"predicted {expect}")
    if counts != expect or any(v <= 0 for v in counts.values()):
        raise AssertionError(f"{label}: launch counts {counts} != predicted {expect}")
    change = float(np.abs(out - c_uhd.astype(np.float32) / 255.0).mean())
    if not (out.shape == c_uhd.shape and np.isfinite(out).all()
            and out.min() >= 0.0 and out.max() <= 1.0 and change > 0.02):
        raise AssertionError(f"{label}: bad output: shape {out.shape}, range "
                             f"[{out.min()}, {out.max()}], mean change {change}")
    log(f"{label}: output finite, in [0, 1], mean |out - content| {change:.4f}")
    return {"s": secs, "cold_s": cold, "launches": counts, "mean_change": change}


def cross_card(torch, kc, WCTEngine, bench, c_uhd, s2k, calls_sh) -> dict:
    """Phases 2, 3c, 4c and 5c for shards on different cards (two or more
    visible): the halo kernel reading neighbours' rows on other cards (peer
    pointers, or the copy where the cards have no peer access) against its
    plain version, exactly; the sharded UHD path with neighbouring shards on
    different cards, its launch counts, its output against the single-card
    slab cascade, and its warm time and per-card peak memory."""
    n_cards = torch.cuda.device_count()
    spread = [f"cuda:{i % n_cards}" for i in range(SHARDS)]
    peer = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
            for a in range(n_cards) for b in range(n_cards) if a != b}
    log(f"cross-card: {n_cards} cards, peer access {peer}")
    for n, h, w, c, hm, offset in [(1, 64, 256, 3, 8, 0), (2, 16, 33, 3, 16, 1),
                                   (1, 1024, UHD_W, 3, 288, 0)]:
        x, up, down = (bench.rand(n * h * w * c + offset)[offset:].view(n, h, w, c)
                       for _ in range(3))
        up, down = up.to("cuda:1"), down.to(f"cuda:{n_cards - 1}")
        got = kc.halo_exchange_rows(x, up[:, -hm:], down[:, :hm], hm)
        torch.cuda.synchronize()
        if not (got.device == x.device and torch.equal(
                got, kc.halo_exchange_rows.plain(x, up[:, -hm:], down[:, :hm], hm))):
            raise AssertionError(f"halo_exchange_rows{(n, h, w, c, hm, offset)} with "
                                 f"neighbours on other cards differs from its plain version")
    log("cross-card: halo_exchange_rows with neighbours on other cards equals its plain "
        "version exactly at 3 shapes")
    engine = WCTEngine(mode="16x", space=SHARDS, slab_rows=SHARD_SLAB, devices=spread)
    out = {"main": sharded_main_path(torch, kc, engine, c_uhd, s2k, calls_sh,
                                     "phase 3c (cross-card)"), "peer": peer}
    with torch.inference_mode():
        img, sty = engine._prep(c_uhd), engine._prep(s2k)
        one_card = WCTEngine(mode="16x", slab_rows=SHARD_SLAB).stylize_device(img, sty)
        db = psnr_device(torch, engine.stylize_device(img, sty), one_card)
        del one_card
        for d in range(n_cards):
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        runs, enqueued = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            engine.stylize_device(img, sty)
            enqueued.append((time.perf_counter() - t0) * 1e3)   # the host has enqueued all work
            for d in range(n_cards):
                torch.cuda.synchronize(d)
            runs.append((time.perf_counter() - t0) * 1e3)
        peaks = [torch.cuda.max_memory_allocated(d) / 2**30 for d in range(n_cards)]
    log(f"phase 4c/5c (cross-card): vs the single-card slab cascade PSNR {db:.2f} dB (min "
        f"{PSNR_MIN_DB}); warm sharded UHD cascade on {spread} "
        f"{statistics.median(runs):.2f} ms (runs {', '.join(f'{r:.2f}' for r in runs)}; the "
        f"host had enqueued all work after {', '.join(f'{r:.2f}' for r in enqueued)} ms), "
        f"peak GiB per card {', '.join(f'{p:.2f}' for p in peaks)}")
    if not db >= PSNR_MIN_DB:
        raise AssertionError(f"cross-card sharded vs single-card PSNR {db:.2f} dB")
    out.update(psnr_db=db, runs_ms=runs, enqueued_ms=enqueued,
               median_ms=statistics.median(runs), peak_gib=peaks)
    return out


def _walls(torch, order, run) -> dict:
    """Host-to-host wall milliseconds of ``run(label)`` per label, in the
    given order (labels in turns on one card), after one warm call each."""
    for label in dict.fromkeys(order):
        run(label)
    walls: dict = {label: [] for label in order}
    for label in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(label)
        torch.cuda.synchronize()
        walls[label].append((time.perf_counter() - t0) * 1e3)
    return walls


def _fmt(walls) -> str:
    return "; ".join(f"{k} {statistics.median(v):.1f} ms (runs {', '.join(f'{x:.1f}' for x in v)})"
                     for k, v in walls.items())


def host_boundary(torch, kc, slab_eng, eng, c_uhd, c2k, s2k, expect_uhd) -> dict:
    """Phase 6: the host boundary on the card (see the module docstring)."""
    from collaborative_distillation_tpu_torch.data import native_codec as nc
    from collaborative_distillation_tpu_torch.utils.colorspace import (rgb_to_yuv420_host,
                                                                       yuv420_to_rgb_host)
    from collaborative_distillation_tpu_torch.utils.transfer import push
    dev = eng.device
    out: dict = {"codec_built": nc.available(), "codec_reason": nc.unavailable_reason()}
    # ---- 6a: the codec, and the JPEG endpoints at UHD (the slice's main path)
    if out["codec_built"]:
        log(f"phase 6a: native codec built from native/imgcodec.cpp into {nc.build_dir()}")
        jpeg = nc.encode_jpeg_yuv420(*nc.rgb_to_yuv420(c_uhd), quality=95)
        y, cbcr = nc.decode_jpeg_yuv420(jpeg)
        for k in kc.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        body = slab_eng.stylize_jpeg(jpeg, s2k)
        jpeg_s = time.perf_counter() - t0
        counts = {k.__name__: k.launches for k in kc.KERNELS}
        whole = nc.encode_jpeg_yuv420(*slab_eng.stylize_planes(y, cbcr, s2k), quality=95)
        planes_body = slab_eng.stylize_planes_jpeg(y, cbcr, s2k)
        log(f"phase 6a: stylize_jpeg {UHD_H}x{UHD_W} ({len(jpeg)} B in, "
            f"{0 if body is None else len(body)} B out) in {jpeg_s:.3f} s; launches {counts}, "
            f"predicted {expect_uhd}; bytes equal to stylize_planes + encode: "
            f"{body == whole}; stylize_planes_jpeg's: {planes_body == whole}")
        if counts != expect_uhd or any(v <= 0 for n, v in counts.items()
                                       if n != "halo_exchange_rows"):
            raise AssertionError(f"stylize_jpeg launches {counts} != predicted {expect_uhd}")
        if body is None or body != whole or planes_body != whole:
            raise AssertionError("streamed JPEG bytes differ from stylize_planes + encode")
        rgb = yuv420_to_rgb_host(*(p[None] for p in nc.decode_jpeg_yuv420(body)))[0]
        change = float(np.abs(rgb.astype(np.float32) - c_uhd).mean()) / 255.0
        if not (rgb.shape == c_uhd.shape and change > 0.02):
            raise AssertionError(f"stylize_jpeg output {rgb.shape}, mean change {change}")
        out.update(jpeg_s=jpeg_s, launches=counts, jpeg_in_bytes=len(jpeg),
                   jpeg_out_bytes=len(body), mean_change=change)
    else:
        log(f"phase 6a: native codec NOT built ({out['codec_reason']}); the reference's "
            f"contract for a machine without it is checked instead")
        y, cbcr = (p[0] for p in rgb_to_yuv420_host(c_uhd[None]))   # numpy
        streamable = slab_eng.supports_streamed_jpeg()
        nones = (slab_eng.stylize_jpeg(b"\xff\xd8\xff", s2k),
                 slab_eng.stylize_planes_jpeg(y, cbcr, s2k))
        log(f"phase 6a: supports_streamed_jpeg() {streamable}; stylize_jpeg and "
            f"stylize_planes_jpeg return {nones}")
        if not streamable or nones != (None, None):
            raise AssertionError("the no-codec contract does not hold")
        for k in kc.KERNELS:
            k.launches = 0
        slab_eng.stylize_planes(y, cbcr, s2k)
        counts = {k.__name__: k.launches for k in kc.KERNELS}
        log(f"phase 6a: stylize_planes {UHD_H}x{UHD_W} launches {counts}, predicted {expect_uhd}")
        if counts != expect_uhd:
            raise AssertionError(f"stylize_planes launches {counts} != predicted {expect_uhd}")
        out.update(launches=counts)
    # ---- 6b: stylize_planes against the RGB transport, Y planes
    yo, _ = slab_eng.stylize_planes(y, cbcr, s2k)
    rgb_in = yuv420_to_rgb_host(y[None], cbcr[None])[0]
    y_rgb = rgb_to_yuv420_host(slab_eng.stylize(rgb_in, s2k, as_uint8=True,
                                                transport="rgb")[None])[0][0]
    db = psnr(yo / 255.0, y_rgb / 255.0)
    log(f"phase 6b: stylize_planes {UHD_H}x{UHD_W} Y plane vs the rgb transport's PSNR "
        f"{db:.2f} dB (min {PSNR_MIN_DB})")
    out["planes_vs_rgb_y_db"] = db
    if not db >= PSNR_MIN_DB:
        raise AssertionError(f"stylize_planes vs rgb transport {db:.2f} dB")
    # ---- 6c: uint8 host-to-host walls by transport, and push's staging
    sizes = [("2048^2", c2k, eng)]
    if out["codec_built"]:   # without the codec the UHD conversion is numpy's: left out
        sizes.append(("UHD", c_uhd, slab_eng))
    out["walls_ms"], out["timed"] = {}, {}
    for label, c, e in sizes:
        walls = _walls(torch, ["rgb", "yuv420", "yuv420", "rgb", "rgb", "yuv420"],
                       lambda tr: e.stylize(c, s2k, as_uint8=True, transport=tr))
        out["walls_ms"][label] = walls
        for tr in ("rgb", "yuv420"):
            e.stylize(c, s2k, as_uint8=True, transport=tr, timed=True)
            out["timed"][f"{label} {tr}"] = e.last_timings
        log(f"phase 6c: stylize(as_uint8=True) {label} host to host: {_fmt(walls)}; one timed "
            f"call each: {out['timed'][f'{label} rgb']}, {out['timed'][f'{label} yuv420']}")
    out["push_ms"] = {}
    for label, c in (("2048^2", c2k), ("UHD", c_uhd)):
        want = torch.from_numpy(c).to(dev)
        for chunk in PUSH_CHUNKS:
            if not torch.equal(push(c, dev, chunk_bytes=chunk), want):
                raise AssertionError(f"push {label} chunk {chunk} differs from .to()")
        ways = {"pageable .to()": lambda: torch.from_numpy(c).to(dev),
                **{f"push {ch >> 20} MiB": (lambda ch=ch: push(c, dev, chunk_bytes=ch))
                   for ch in PUSH_CHUNKS}}
        order = list(ways) + list(ways)[::-1] + list(ways)
        walls = _walls(torch, order, lambda w: ways[w]())
        out["push_ms"][label] = walls
        log(f"phase 6c: upload {label} uint8 RGB ({c.nbytes} B) host to device: {_fmt(walls)}")
        del want
    # ---- 6d: stylize_pairs against serial stylize calls
    contents = [np.ascontiguousarray(x) for x in (c2k, c2k[::-1], c2k[:, ::-1], c2k[::-1, ::-1])]
    results: dict = {}

    def run(mode):
        if mode == "serial":
            results[mode] = [eng.stylize(c, s2k, as_uint8=True) for c in contents]
        else:
            results[mode] = list(eng.stylize_pairs([(c, s2k) for c in contents]))
        if "serial" in results and "stylize_pairs" in results and not all(
                np.array_equal(a, b) for a, b in zip(results["serial"], results["stylize_pairs"])):
            raise AssertionError("stylize_pairs differs from serial stylize calls")

    walls = _walls(torch, ["serial", "stylize_pairs", "stylize_pairs", "serial"], run)
    out["pairs_ms"] = walls
    log(f"phase 6d: 4 uint8 2048^2 pairs, bit-equal to serial stylize: {_fmt(walls)}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from collaborative_distillation_tpu_torch.ops import cuda as kc
    from collaborative_distillation_tpu_torch.ops.cuda import _build
    from collaborative_distillation_tpu_torch.ops.wct_transform import (coloring_matrix,
                                                                        feature_stats)
    from collaborative_distillation_tpu_torch.models.vgg import apply_decoder, apply_encoder
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine, stylize_stage
    from collaborative_distillation_tpu_torch.wct.slab import (FEATURE_CACHE_BYTES,
                                                               build_fused_slab_cascade)

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
    c_uhd = reflect_tile(torch, c512, UHD_H, UHD_W)
    slab_eng = WCTEngine(mode="16x", slab_rows=UHD_SLAB)
    cas = slab_eng.slab
    calls_uhd, layers_uhd = slab_path_calls(pyr, eng.stages, cas.margins, cas.slab_rows,
                                            UHD_H, UHD_W, 2048, 2048, FEATURE_CACHE_BYTES)
    shard_eng = WCTEngine(mode="16x", space=SHARDS, slab_rows=SHARD_SLAB,
                          devices=["cuda:0"] * SHARDS)
    calls_sh, layers_sh = sharded_path_calls(pyr, eng.stages, cas.margins,
                                             shard_eng._tiled_slab, SHARDS, UHD_H, UHD_W,
                                             2048, 2048)
    names = [k.__name__ for k in kc.KERNELS]
    if "--cross-card" in sys.argv[1:]:
        # only what exists across cards: needs two or more, prints no kernel table
        if torch.cuda.device_count() < 2:
            print("chip_smoke --cross-card: needs two or more CUDA devices", file=sys.stderr)
            return 1
        detail["cross_card"] = cross_card(torch, kc, WCTEngine, bench, c_uhd, s2k, calls_sh)
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_smoke_cross_card.json"), "w") as f:
            json.dump(detail, f, indent=1)
        print(smi)
        return 0

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
    # sum_gram: (P, C) or (P, C, float offset): a stage-1 row count, odd and
    # tiled widths, one row, one past a staging block (300, 250, 126 and 64
    # rows at C = 24, 32, 64, 128) and a fold chunk (6300 and 6250 rows per
    # block of the launch plan at C = 24 and 32), starts that are not
    # 16-byte aligned
    edge += [("sum_gram", s) for s in
             [(1000, 24), (777, 128), (5000, 512), (1, 3), (4194304, 24), (1, 1),
              (1000, 3), (999, 5), (500, 129), (2000, 512), (1, 24), (1, 128),
              (301, 24), (251, 32), (127, 64), (65, 128), (1663201, 24), (825001, 32),
              (1000, 3, 1), (1000, 24, 1), (257, 128, 3)]]
    # conv1x1: (N, H, W, Cin, Cout, relu, bias, float offset)
    edge += [("conv1x1_bias", s) for s in
             [(1, 1, 1, 8, 8, False, True, 0), (1, 1, 1, 128, 128, True, True, 0),
              (1, 7, 13, 24, 24, True, True, 0), (1, 9, 33, 128, 24, False, False, 0),
              (1, 5, 31, 24, 128, False, True, 1), (1, 16, 17, 8, 128, True, True, 3),
              (2, 4, 5, 3, 24, False, True, 0), (1, 3, 11, 128, 8, True, False, 2)]]
    # halo: (N, H, W, C, hm, position, float offset): one row, the whole
    # neighbour, N = 2, W*C not a multiple of 4, shards at odd offsets
    edge += [("halo_exchange_rows", s) for s in
             [(1, 8, 16, 8, 1, "mid", 0), (1, 8, 16, 8, 8, "mid", 0), (2, 8, 16, 8, 2, "mid", 0),
              (1, 6, 5, 3, 2, "mid", 0), (2, 6, 5, 3, 3, "first", 1), (1, 4, 7, 1, 1, "last", 3),
              (2, 64, 33, 3, 32, "mid", 2), (1, 1, 9, 4, 1, "mid", 0)]]
    for kernel, shape in edge:
        checks.append(bench.run(kernel, shape))
    # the per-conv exchange's sources at a global edge: the shard's own rows
    xr = bench.rand(2, 6, 5, 3)
    if not torch.equal(kc.halo_exchange_rows(xr, xr[:, 1:2], xr[:, -2:-1], 1),
                       kc.halo_exchange_rows.plain(xr, xr[:, 1:2], xr[:, -2:-1], 1)):
        raise AssertionError("halo_exchange_rows with the shard's own reflection rows")
    # every (kernel, shape) of the UHD slab path (slabs 10240 wide, sum_gram
    # over 10.5M rows), and the plain UHD cascade's largest conv map (past
    # 2^31 bytes), the yardstick of phase 4b
    calls_plain_uhd, layers_plain_uhd = path_calls(pyr, eng.stages, UHD_H, UHD_W)
    biggest = max((s for kernel, s in calls_plain_uhd if kernel == "conv3x3_reflect"),
                  key=lambda s: s[1] * s[2] * (s[3] + s[4]))
    t0 = time.perf_counter()
    for kernel, shape in sorted(calls_uhd, key=str):
        checks.append(bench.run(kernel, shape, layers_uhd.get(shape)))
    checks.append(bench.run("conv3x3_reflect", biggest, layers_plain_uhd[biggest]))
    # every (kernel, shape) of the sharded UHD path that the slab path lacks:
    # the halo at each (stage, shard position), slabs of 512 + 2 * margin rows
    only_sh = sorted(set(calls_sh) - set(calls_uhd), key=str)
    for kernel, shape in only_sh:
        checks.append(bench.run(kernel, shape, layers_sh.get(shape)))
    n_halo = sum(kernel == "halo_exchange_rows" for kernel, _ in only_sh)
    log(f"phase 2: {len(checks)} kernel-vs-plain checks passed at the 512^2 path, edge, "
        f"all {len(calls_uhd)} UHD slab path, the plain UHD {biggest} and the "
        f"{len(only_sh)} further sharded UHD path shapes ({n_halo} of the halo, exact; "
        f"UHD ones in {time.perf_counter() - t0:.1f} s)")
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
    # the whole 16x16 cascade: relu5_1 is 1x1, its covariance 0/0; the
    # reference stylizes to all-NaN, and so must the port, without raising
    for e in (eng, slab_eng):
        o = e.stylize(tiny[0], tiny[0])
        if not (o.shape == (16, 16, 3) and np.isnan(o).all()):
            raise AssertionError(f"16x16 cascade: {np.isnan(o).mean():.3f} NaN, expected all")
    log("phase 2: 16x16 cascade all-NaN on the plain path and the slab engine's bypass")

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
    # UHD stage-1 statistics from the slab sums (4 slabs, one shift), and the
    # plain path's whole-map statistics, against float64
    with torch.inference_mode():
        img_uhd = eng._prep(c_uhd)
        mean_s, cov_s, _ = cas.content_stats(1, img_uhd)
        feats = apply_encoder(pyr[1]["enc"], img_uhd, pyr[1]["enc_spec"], aux=False)["out"]
        mean_f, cov_f = feature_stats(feats)
        m64, cov64 = stats64(feats)
        slab_err, full_err = rel_err(cov_s, cov64), rel_err(cov_f, cov64)
        slab_mean_err = rel_err(mean_s, m64)
        p_uhd = feats.shape[1] * feats.shape[2]
        del feats
    log(f"phase 2: stage-1 UHD covariance ({p_uhd} x 24) vs float64 centred: slab sums "
        f"rel err {slab_err:.3e}, whole map {full_err:.3e} (tol {COV64_TOL}); slab mean "
        f"rel err {slab_mean_err:.3e}")
    detail["cov64_uhd"] = {"slab_rel_err": slab_err, "whole_map_rel_err": full_err,
                           "slab_mean_rel_err": slab_mean_err}
    if not max(slab_err, full_err) <= COV64_TOL:
        raise AssertionError(f"UHD stage-1 covariance rel err {slab_err}, {full_err}")

    # ---- phase 3: the main path at 2048^2 ----------------------------------
    for k in kc.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = eng.stylize(c2k, s2k, alpha=1.0)
    main_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kc.KERNELS}
    expect = {n: sum(c for (kernel, _), c in calls2k.items() if kernel == n) for n in names}
    log(f"phase 3: stylize 2048^2 in {main_s:.3f} s (first call, host transfer "
        f"included); launches {launches}, predicted {expect}")
    if launches != expect or any(launches[n] <= 0 for n in names if n not in KERNEL_PATH):
        raise AssertionError(f"launch counts {launches} != predicted {expect}")
    content_f = c2k.astype(np.float32) / 255.0
    change = float(np.abs(out - content_f).mean())
    if not (out.shape == c2k.shape and np.isfinite(out).all()
            and out.min() >= 0.0 and out.max() <= 1.0 and change > 0.02):
        raise AssertionError(f"bad 2048^2 output: shape {out.shape}, range "
                             f"[{out.min()}, {out.max()}], mean change {change}")
    log(f"phase 3: output finite, in [0, 1], mean |out - content| {change:.4f}")
    del out

    # ---- phase 3b: the UHD slab path -----------------------------------------
    t0 = time.perf_counter()
    slab_eng.stylize(c_uhd, s2k)   # warm: first cuSOLVER/cuBLAS calls at these shapes
    cold_s = time.perf_counter() - t0
    for k in kc.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out_uhd = slab_eng.stylize(c_uhd, s2k, alpha=1.0)
    uhd_s = time.perf_counter() - t0
    launches_uhd = {k.__name__: k.launches for k in kc.KERNELS}
    expect_uhd = {n: sum(c for (kernel, _), c in calls_uhd.items() if kernel == n)
                  for n in names}
    log(f"phase 3b: stylize {UHD_H}x{UHD_W} slab_rows={UHD_SLAB} in {uhd_s:.3f} s warm "
        f"({cold_s:.3f} s first call; host transfer included); margins {cas.margins}; "
        f"launches {launches_uhd}, predicted {expect_uhd}")
    if launches_uhd != expect_uhd or any(v <= 0 for n, v in launches_uhd.items()
                                         if n != "halo_exchange_rows"):
        raise AssertionError(f"UHD launch counts {launches_uhd} != predicted {expect_uhd}")
    change = float(np.abs(out_uhd - c_uhd.astype(np.float32) / 255.0).mean())
    if not (out_uhd.shape == c_uhd.shape and np.isfinite(out_uhd).all()
            and out_uhd.min() >= 0.0 and out_uhd.max() <= 1.0 and change > 0.02):
        raise AssertionError(f"bad UHD output: shape {out_uhd.shape}, range "
                             f"[{out_uhd.min()}, {out_uhd.max()}], mean change {change}")
    log(f"phase 3b: output finite, in [0, 1], mean |out - content| {change:.4f}")
    detail["uhd_main"] = {"s": uhd_s, "cold_s": cold_s, "launches": launches_uhd,
                          "mean_change": change}
    del out_uhd

    # ---- phase 3c: the sharded UHD path, four row shards on the one card --------
    detail["sharded_main"] = sharded_main_path(torch, kc, shard_eng, c_uhd, s2k, calls_sh,
                                               "phase 3c")
    launches_sh = detail["sharded_main"]["launches"]
    if torch.cuda.device_count() >= 2:
        detail["cross_card"] = cross_card(torch, kc, WCTEngine, bench, c_uhd, s2k, calls_sh)
    else:
        log("phase 3c: one card: the four shards shared it; no cross-card run was made "
            "(peer pointers and the event ordering between cards' streams are not "
            "exercised here)")

    # ---- phase 4: 512^2 card vs CPU plain cascade ---------------------------
    o_card = eng.stylize(c512, s512)
    o_cpu = eng_cpu.stylize(c512, s512)
    db = psnr(o_card, o_cpu)
    log(f"phase 4: 512^2 card vs cpu PSNR {db:.2f} dB (min {PSNR_MIN_DB})")
    detail["psnr_512_card_vs_cpu_db"] = db
    if not db >= PSNR_MIN_DB:
        raise AssertionError(f"512^2 card vs cpu PSNR {db:.2f} dB < {PSNR_MIN_DB}")

    # ---- phase 4b: slab against plain on the card ------------------------------
    with torch.inference_mode():
        sty2k, img2k = eng._prep(s2k), eng._prep(c2k)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plain_uhd = eng.stylize_device(img_uhd, sty2k)
        torch.cuda.synchronize()
        plain_uhd_s = time.perf_counter() - t0
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
        db_uhd = psnr_device(torch, slab_eng.stylize_device(img_uhd, sty2k), plain_uhd)
        del plain_uhd
        db_2k = psnr_device(torch, WCTEngine(mode="16x", slab_rows=512).stylize_device(img2k, sty2k),
                            eng.stylize_device(img2k, sty2k))
        stats2k = {k: eng._style_stats(k, sty2k) for k in eng.stages}
        on, off = (build_fused_slab_cascade(pyr, slab_rows=512, external_style_stats=True,
                                            feature_cache_bytes=b)(img2k, stats2k, 1.0)
                   for b in (FEATURE_CACHE_BYTES, 0))
        cache_err = float((on - off).abs().max())
        del on, off
    log(f"phase 4b: UHD slab vs plain on the card PSNR {db_uhd:.2f} dB (plain UHD cascade "
        f"{plain_uhd_s:.3f} s, peak {plain_peak:.2f} GiB); 2048^2 slab_rows=512 vs plain "
        f"{db_2k:.2f} dB (min {PSNR_MIN_DB}); feature cache on vs off max abs diff "
        f"{cache_err:.3e} (tol {CACHE_TOL})")
    detail["slab_vs_plain"] = {"uhd_psnr_db": db_uhd, "psnr_2048_db": db_2k,
                               "cache_on_off_max_abs": cache_err,
                               "plain_uhd_s": plain_uhd_s, "plain_uhd_peak_gib": plain_peak}
    if not (db_uhd >= PSNR_MIN_DB and db_2k >= PSNR_MIN_DB and cache_err <= CACHE_TOL):
        raise AssertionError(f"slab vs plain: UHD {db_uhd:.2f} dB, 2048^2 {db_2k:.2f} dB, "
                             f"cache on/off {cache_err}")

    # ---- phase 4c: sharded against single-card, slab and per-conv ---------------
    with torch.inference_mode():
        one_card = WCTEngine(mode="16x", slab_rows=SHARD_SLAB).stylize_device(img_uhd, sty2k)
        db_sh = psnr_device(torch, shard_eng.stylize_device(img_uhd, sty2k), one_card)
        del one_card
        before = kc.halo_exchange_rows.launches
        per_conv = WCTEngine(mode="16x", space=SHARDS, devices=["cuda:0"] * SHARDS)
        db_pc = psnr_device(torch, per_conv.stylize_device(img2k, sty2k),
                            eng.stylize_device(img2k, sty2k))
        pc_halos = kc.halo_exchange_rows.launches - before
    # one exchange per conv and shard, content and style
    pc_expect = SHARDS * sum(c for (kernel, _), c in calls2k.items()
                             if kernel == "conv3x3_reflect")
    log(f"phase 4c: UHD sharded (space={SHARDS}, slab_rows={SHARD_SLAB}) vs the single-card "
        f"slab cascade at the same slab size PSNR {db_sh:.2f} dB; 2048^2 per-conv sharded "
        f"vs plain {db_pc:.2f} dB (min {PSNR_MIN_DB}); per-conv halo launches {pc_halos}, "
        f"predicted {pc_expect}")
    detail["sharded_vs_single"] = {"uhd_psnr_db": db_sh, "per_conv_2048_psnr_db": db_pc,
                                   "per_conv_halo_launches": pc_halos}
    if not (db_sh >= PSNR_MIN_DB and db_pc >= PSNR_MIN_DB and pc_halos == pc_expect):
        raise AssertionError(f"sharded vs single-card: UHD {db_sh:.2f} dB, per-conv "
                             f"{db_pc:.2f} dB, halo launches {pc_halos} != {pc_expect}")

    # ---- phase 4d: a height that is no slab multiple ----------------------------
    from collaborative_distillation_tpu_torch.parallel.spatial import shard_rows
    with torch.inference_mode():
        img_awk = img_uhd[:, :AWK_H]
        plain_awk = eng.stylize_device(img_awk, sty2k)
        slab_awk = slab_eng.stylize_device(img_awk, sty2k)
        shard_awk = shard_eng.stylize_device(img_awk, sty2k)
        db_awk = psnr_device(torch, slab_awk, plain_awk)
        db_awk_sh = psnr_device(torch, shard_awk, slab_awk)
        db_awk_sh_plain = psnr_device(torch, shard_awk, plain_awk)
        del img_awk, plain_awk, slab_awk, shard_awk
    awk_windows = len(list(cas._slabs(AWK_H, 1)))
    awk_shards = shard_rows(AWK_H, shard_eng._tiled_slab, SHARDS)
    log(f"phase 4d: {AWK_H}x{UHD_W} (slab_rows={UHD_SLAB}: {awk_windows} windows, the last "
        f"shifted to end at the image): slab vs plain PSNR {db_awk:.2f} dB; sharded "
        f"(space={SHARDS}, slab_rows={shard_eng._tiled_slab}, shard rows {awk_shards}) vs the "
        f"single-card slab cascade {db_awk_sh:.2f} dB, vs plain {db_awk_sh_plain:.2f} dB "
        f"(min {PSNR_MIN_DB})")
    detail["awkward_height"] = {"h": AWK_H, "slab_vs_plain_db": db_awk,
                                "sharded_vs_slab_db": db_awk_sh,
                                "sharded_vs_plain_db": db_awk_sh_plain,
                                "shard_rows": awk_shards}
    if not (db_awk >= PSNR_MIN_DB and db_awk_sh >= PSNR_MIN_DB):
        raise AssertionError(f"awkward height: slab vs plain {db_awk:.2f} dB, sharded vs "
                             f"slab {db_awk_sh:.2f} dB")

    # ---- phase 5: timings at the 2048^2 path shapes -------------------------
    rows = []
    for (kernel, shape), n in sorted(calls2k.items(), key=str):
        r = bench.run(kernel, shape, layers2k.get(shape), timed=True)
        r["calls"] = n
        rows.append(r)
    # conv1x1_bias lies on the UHD slab path only: timed at its shapes there
    for (kernel, shape), n in sorted(calls_uhd.items(), key=str):
        if kernel == "conv1x1_bias":
            r = bench.run(kernel, shape, timed=True)
            r["calls"] = n
            rows.append(r)
    # sum_gram at the UHD slab path's shapes too (the 2048^2 style's and the
    # slabs' interior rows): a second summary on the kernel's row
    rows_sg_uhd = []
    for (kernel, shape), n in sorted(calls_uhd.items(), key=str):
        if kernel == "sum_gram":
            r = bench.run(kernel, shape, timed=True)
            r["calls"] = n
            rows_sg_uhd.append(r)
    # halo_exchange_rows lies on the sharded UHD path only
    for (kernel, shape), n in sorted(calls_sh.items(), key=str):
        if kernel == "halo_exchange_rows":
            r = bench.run(kernel, shape, timed=True)
            r["calls"] = n
            rows.append(r)
    path_launches = {**launches, "conv1x1_bias": launches_uhd["conv1x1_bias"],
                     "halo_exchange_rows": launches_sh["halo_exchange_rows"]}
    sg_uhd = {"launches": launches_uhd["sum_gram"], **path_times(rows_sg_uhd)}
    log(f"phase 5b: sum_gram per UHD slab cascade {sg_uhd['ms']:.3f} ms over "
        f"{sg_uhd['launches']} launches, plain {sg_uhd['plain_ms']:.3f}, x.T @ x "
        f"{sg_uhd['library_ms']:.3f}, bound {sg_uhd['bound_ms']:.3f} ({sg_uhd['bound_by']})")
    table = []
    for k in kc.KERNELS:
        name = k.__name__
        src, rep = KERNEL_META[name]
        errs = [r["max_abs_err"] for r in checks + rows if r["kernel"] == name]
        rel = [r["max_rel_err"] for r in checks + rows if r["kernel"] == name]
        table.append({
            "name": name, "route": "cuda", "source": REPO_PATH + src, "replaces": rep,
            "launches": path_launches[name], "max_abs_err": max(errs), "max_err": max(errs),
            "path": KERNEL_PATH.get(name, "2048^2 plain"),
            "max_rel_err": max(rel),
            **path_times([r for r in rows if r["kernel"] == name]),
            **({"uhd_slab": sg_uhd} if name == "sum_gram" else {})})
    detail["shapes_timed"] = rows + rows_sg_uhd
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
        resident = torch.cuda.memory_allocated() / 2**30
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
                                 "stages": stage_ms, "peak_gib": peak,
                                 "resident_before_gib": resident}
    log(f"phase 5: 2048^2 cascade warm {statistics.median(runs):.2f} ms "
        f"(runs {', '.join(f'{r:.2f}' for r in runs)}), peak {peak:.2f} GiB "
        f"({resident:.2f} GiB held before it, the UHD phases' inputs among them); stages "
        + ", ".join(f"{k}: {v:.2f} ms" for k, v in stage_ms.items()))
    detail["profile_2048"] = profile_cascade(torch, eng, img, sty)
    del img, x

    # ---- phase 5b: the warm UHD slab cascade -----------------------------------
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident_uhd = torch.cuda.memory_allocated() / 2**30
        runs_uhd = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slab_eng.stylize_device(img_uhd, sty2k)
            torch.cuda.synchronize()
            runs_uhd.append((time.perf_counter() - t0) * 1e3)
        peak_uhd = torch.cuda.max_memory_allocated() / 2**30
        # one cascade driven stage by stage through the fused cascade's own
        # parts: pass 1 (encode, statistics, coloring matrix), pass 2 (folded
        # WCT, decode); the style statistics are taken before it
        part = slab_eng._fused_fn(cas.slab_rows, False).cascade
        sstats = slab_eng._fused_style_stats(sty2k)
        alpha = torch.tensor(1.0, device="cuda")
        x, split = img_uhd, {}
        for k in slab_eng.stages:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            keep = part.feature_bytes(k, *x.shape[1:3]) <= FEATURE_CACHE_BYTES
            cm, cc, kept = part.content_stats(k, x, keep=keep)
            t = coloring_matrix(cc, sstats[k][1], method=part.method, eps=part.eps,
                                newton_iters=part.newton_iters)
            ev[1].record()
            x = part.color_decode_stage(k, x, t, cm, sstats[k][0], alpha, kept=kept)
            ev[2].record()
            torch.cuda.synchronize()
            split[k] = {"pass1_ms": ev[0].elapsed_time(ev[1]),
                        "pass2_ms": ev[1].elapsed_time(ev[2]), "feature_cache": keep}
        del x, kept
    detail["cascade_uhd_ms"] = {"runs": runs_uhd, "median": statistics.median(runs_uhd),
                                "stages": split, "peak_gib": peak_uhd,
                                "resident_before_gib": resident_uhd}
    log(f"phase 5b: UHD slab cascade warm {statistics.median(runs_uhd):.2f} ms (runs "
        f"{', '.join(f'{r:.2f}' for r in runs_uhd)}; style statistics included), peak "
        f"{peak_uhd:.2f} GiB ({resident_uhd:.2f} GiB held before it); stages (pass 1 / "
        f"pass 2 ms): "
        + ", ".join(f"{k}: {v['pass1_ms']:.2f} / {v['pass2_ms']:.2f}" for k, v in split.items()))
    detail["profile_uhd"] = profile_cascade(torch, slab_eng, img_uhd, sty2k, "phase 5b")
    # uint8 host to host: the streamed last stage against the whole cascade
    # then one copy, in turns on one card; the tail decodes stage 1 from pass
    # 1's kept features, so both launch what the slab plan predicts
    walls, u8 = {"not streamed": [], "streamed": []}, {}
    stream_min = slab_eng.stream_min_pix
    slab_eng.stylize(c_uhd, s2k, as_uint8=True)   # warm: the first pinned staging buffers
    for mode in ("not streamed", "streamed", "streamed", "not streamed", "not streamed",
                 "streamed"):
        slab_eng.stream_min_pix = stream_min if mode == "streamed" else UHD_H * UHD_W + 1
        for k in kc.KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u8[mode] = slab_eng.stylize(c_uhd, s2k, as_uint8=True)
        walls[mode].append((time.perf_counter() - t0) * 1e3)
        counts = {k.__name__: k.launches for k in kc.KERNELS}
        if counts != expect_uhd:
            raise AssertionError(f"{mode}: launches {counts} != predicted {expect_uhd}")
    slab_eng.stream_min_pix = stream_min
    u8_diff = int(np.abs(u8["streamed"].astype(np.int16) - u8["not streamed"]).max())
    detail["uhd_uint8_wall_ms"] = {**walls, "max_level_diff": u8_diff}
    log(f"phase 5b: stylize(as_uint8=True) {UHD_H}x{UHD_W} host to host: not streamed "
        f"{', '.join(f'{w:.1f}' for w in walls['not streamed'])} ms, streamed "
        f"{', '.join(f'{w:.1f}' for w in walls['streamed'])} ms; max level diff {u8_diff}")
    if not (u8["streamed"].shape == c_uhd.shape and u8_diff <= 1):
        raise AssertionError(f"streamed vs not streamed uint8: {u8_diff} levels")
    # ---- phase 5c: the warm sharded UHD cascade ----------------------------------
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident_sh = torch.cuda.memory_allocated() / 2**30
        runs_sh, enqueued_sh = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            shard_eng.stylize_device(img_uhd, sty2k)
            enqueued_sh.append((time.perf_counter() - t0) * 1e3)   # the host has enqueued all work
            torch.cuda.synchronize()
            runs_sh.append((time.perf_counter() - t0) * 1e3)
        peak_sh = torch.cuda.max_memory_allocated() / 2**30
    detail["cascade_sharded_ms"] = {"runs": runs_sh, "median": statistics.median(runs_sh),
                                    "enqueued_ms": enqueued_sh,
                                    "peak_gib": peak_sh, "resident_before_gib": resident_sh}
    log(f"phase 5c: UHD sharded cascade (space={SHARDS} on one card, slab_rows={SHARD_SLAB}) "
        f"warm {statistics.median(runs_sh):.2f} ms (runs "
        f"{', '.join(f'{r:.2f}' for r in runs_sh)}; style statistics included; the host had "
        f"enqueued all work after {', '.join(f'{r:.2f}' for r in enqueued_sh)} ms), peak "
        f"{peak_sh:.2f} GiB ({resident_sh:.2f} GiB held before it)")
    detail["profile_sharded"] = profile_cascade(torch, shard_eng, img_uhd, sty2k, "phase 5c")
    detail["host_boundary"] = host_boundary(torch, kc, slab_eng, eng, c_uhd, c2k, s2k,
                                            expect_uhd)
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
