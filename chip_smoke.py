#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one GPU and hold every kernel against
its plain PyTorch version.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card, the versions, and the build of the CUDA kernels from
     ``collaborative_distillation_tpu_torch/ops/cuda/csrc``; whether the CUDA
     toolkit ships nvJPEG (``include/nvjpeg.h``, ``lib64/libnvjpeg.so*``;
     recorded only);
  2. each kernel against its plain version on the card, at every distinct
     shape of the mode-16x cascade at 512^2 and of the UHD slab cascade,
     the plain UHD cascade's largest conv map, plus edge shapes (1-pixel maps, odd sizes, C not a multiple of 4,
     unaligned slices; for both convs one past each template's pixel tile,
     off 16-byte alignment); ``halo_exchange_rows`` exactly, at every (stage,
     shard position) shape of the sharded UHD path and at edge shapes (one
     row, the whole neighbour, N = 2, odd row sizes, offset slices, the
     shard's own reflection rows as sources) and, exactly, at every shape of
     the per-conv sharded path at 2000 x 2048 (shards of unequal heights);
     conv3x3 on every max-unpooled map of the 2048^2 photo-WCT decoders (3
     of 4 values 0); a 16x16 image (relu5_1 at 1x1) stylizes to all-NaN
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
     the same slab size (PSNR), and the per-conv sharded cascade (``space=4``
     without ``slab_rows``: whole 16-row blocks per shard, the style's
     statistics taken whole) against the plain one at 2048^2, at a 2000 x
     2048 content and at a 2000 x 2048 style, with its halo launches held to
     the plan's;
  4d. a height that is no slab multiple (4000 x 10240): the slab cascade
     against the plain one, and the sharded cascade against the slab one
     (PSNR; the last window ends at the image, nothing is mirrored in);
  5. timings: each kernel, its plain version and one library call at every
     2048^2 shape of the path, weighted by the calls per cascade, beside the
     least time the card could take (each conv3x3 row with the template its
     launch plan chose); the warm 2048^2 cascade and its stages, its FLOPs
     (``utils/flops.py:cascade_flops``, no style leg) over the warm median
     of the cascade with the style's statistics cached, against the card's
     FP32 peak (``card_peak_flops``);
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
     uint8 pairs, bit-equal to four ``stylize`` calls, and both walls;
  7. the CLIs and the HTTP server (``collaborative_distillation_tpu_torch/cli``),
     bodies and files written and read by the port (PNG; JPEG where the native
     codec is built), each launch count read with the counters zeroed around
     one request or CLI run and held to the plan's, the style's statistics
     cached or not: (a) ``build_app(WCTEngine(mode="16x"))`` on a local
     ThreadingHTTPServer, two registered 2048^2 styles (warm log lines
     awaited), requests at alpha 1 and 0.6, a blend and four concurrent ones,
     each response equal to the engine's direct call (PNG pixels bit-equal, or
     JPEG bytes equal to ``encode_jpeg`` of it), ``/metrics`` (7 requests, 0
     errors, a queue of 2 or more), the p50 and the decode/cascade/encode
     split; (b) a ``slab_rows=1024`` server and one 4096 x 10240 PNG request
     against phase 3b's output (PSNR); (c) ``python -m ...cli.serve --port 0``
     as a process: the bound port from its log, one 512^2 request, exit 0
     after SIGINT; (d) the stylize CLI in process over 2 x 2 pairs at 2048^2
     (``stylize_pairs``; the files equal the engine's outputs; ``--profile``
     writes a trace that names the conv3x3 kernel) and one UHD pair with
     ``--slab_rows 1024`` against phase 3b's output; (e) the eval CLI on four
     256^2 crops, on the card against ``--device cpu``; (f) a seeded
     ``original`` pyramid (teacher widths, Cin/Cout to 512): every kernel at
     its 512^2 path shapes against the plain version, each stage's encoder
     and decoder card vs CPU, and the stylize CLI at its default ``--mode
     original`` on one 512^2 pair;
  8. training (``collaborative_distillation_tpu_torch/train``, ``cli/train.py``),
     TF32 off: (a) the conv3x3, pool and upsample kernels' autograd Functions
     against the plain versions' autograd at every conv, pool and upsample
     shape of a stage-5 step at N = 16, 256^2 (teacher and student widths)
     and edge shapes: conv gradients to ``CONV_TOL`` of the largest partial
     sum under the kernel's own ReLU decisions, pool (ties: the first
     maximum) and upsample exactly, a ReLU at 0 exactly 0.5 g; (b) one step
     of each mode on the card against the CPU (stage 2, N = 2, 64^2: losses
     to 1e-5 relative, student gradients to 1e-4 of each leaf's max|g|,
     frozen gradients None); (c) ``cli.train`` in process at stage 5 x 16 x
     256^2 on 48 PNGs written by the port, six steps each of ``wct_se`` and
     ``wct_sd_kd2sd --updim_relu`` (phase 9c's teacher store, the shipped
     ``16x_base`` students) and ``wct_sd --lw_perc 0`` (the shipped weights
     alone): launches per step held to the specs', finite losses, the
     checkpoint's keys in the reference's layout, ``--resume`` at the next
     epoch, nonzero gradients into the zero-filled aux adapters, the median
     step time, images/s, peak memory and one profiled step's split into the
     hand-written kernels, cuDNN's backward and the rest;
  9. run before phases 7 and 8: (a) photo-WCT, ``stylize(pwct=True)`` at
     2048^2 with the counters zeroed (the plain path's conv3x3 and sum_gram
     launches, ``max_pool_2x2`` for the style only, no upsample), finite and
     unlike ``pwct=False``, the 512^2 pair card vs CPU with the card's pool
     indices shared (each stage's encoder and decoder to STAGE_TOL, the
     cascade as PSNR; without sharing, a printed figure), the warm
     median of 5 and peak memory, the slab and sharded engines' refusals;
     (b) ``stylize_cascade_fn`` at 2048^2 against the engine's unclipped
     output; (c) ``python -m ...cli.make_teacher --out <tmp>`` on the card
     (stages 1-5), timed, each stage's calibration re-run on the store (mean
     activation 1), a stage-2 ``normalize_encoder`` card vs CPU; (d)
     ``apply_mobilenet_encoder`` (stages 1-5, 512^2, a seeded state dict),
     ``gram_matrix`` and ``adain`` card vs CPU.

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

# The card's FP32 peak outside the tensor cores (the FFMA kernels' bound),
# set by main() from utils/flops.py:card_peak_flops; the H100 SXM's HBM3 rate
# (NVIDIA data sheet, at the 700 W limit)
PEAK_FP32_FLOPS = 0.0
PEAK_BYTES = 3.35e12
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
CONV3X3_NAMES = "conv3x3_kernel"   # the profiler's names of csrc/conv3x3.cu's kernels
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
#   a whole encoder or decoder, card vs CPU on the same inputs (phases 2
#     and 9a): 1e-4 of the output's largest magnitude (CONV_TOL compounded
#     over up to 16 convs, pools and unpools; 7.6e-6 read at 16x16).
#   phase 8a, a conv3x3 with a ReLU: the kernel's and the plain version's
#     pre-activations may take opposite sides of 0 where they lie within
#     rounding of it, at most RELU_FLIP_SHARE of a shape's outputs (and 2).
CONV_TOL = 1e-5
STAGE_TOL = 1e-4
RELU_FLIP_SHARE = 1e-5
GRAM_TOL = 2e-5
COV64_TOL = 1e-4
PSNR_MIN_DB = 40.0
CACHE_TOL = 1e-6
UHD_H, UHD_W = 4096, 10240   # the README's 10240x4096 UHD image, rows first
UHD_SLAB = 1024
SHARDS = 4                   # row shards of the sharded UHD path
SHARD_SLAB = 512             # two slabs in each 1024-row shard
AWK_H = 4000                 # phase 4d: no multiple of either slab size
PC_AWK_H = 2000              # phases 2, 4c: a multiple of 16, not of 16 * SHARDS
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


def path_calls(pyramid, stages, h, w, style=True):
    """Kernel calls of one cascade on an (h, w) content and style of the same
    size: {(kernel, shape): count}, plus {shape: (stage, part, layer)} naming
    the first layer that runs each conv shape. ``style=False``: the style's
    statistics are cached (no style encode)."""
    calls, layer_of = Counter(), {}
    for k in stages:
        es, ds = pyramid[k]["enc_spec"], pyramid[k]["dec_spec"]
        for _ in ("style", "content") if style else ("content",):
            hh, ww = _encoder_calls(calls, layer_of, k, es, h, w)
            calls[("sum_gram", (hh * ww, es.out_channels))] += 1
        assert _decoder_calls(calls, layer_of, k, ds, hh, ww) == (h, w)
    return calls, layer_of


def slab_path_calls(pyramid, stages, margins, slab, h, w, sh, sw, cache_bytes, style=True):
    """Kernel calls of one fused slab cascade (no style key: the style is
    encoded whole at every stage; ``style=False``: its statistics are
    cached) on an (h, w) content, h a multiple of ``slab``, and an (sh, sw)
    style, from the stage margins: per stage, pass 1 encodes every extended
    slab and sums its interior feature rows; pass 2 re-encodes unless the
    stage's stacked features fit in ``cache_bytes``, applies the folded WCT
    (``conv1x1_bias``) and decodes."""
    calls, layer_of = Counter(), {}
    n_slabs = h // slab
    for k in stages:
        es, ds = pyramid[k]["enc_spec"], pyramid[k]["dec_spec"]
        c, down = es.out_channels, 2 ** (k - 1)
        if style:
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


def per_conv_halo_calls(pyramid, stages, rows, w):
    """Halo exchanges of one per-conv sharded cascade (``space`` without
    ``slab_rows``) on a content cut into shards of ``rows`` rows, ``w``
    wide: one one-row exchange per shard before each conv of the content's
    encoder and of the decoder (the style's statistics are taken whole, with
    no exchange). Every shard reads both neighbours' rows or, at a global
    edge, its own, so all shapes are "mid" ones."""
    calls = Counter()
    for k in stages:
        down = 2 ** (k - 1)
        for spec, scale in ((pyramid[k]["enc_spec"], 1), (pyramid[k]["dec_spec"], down)):
            f = scale
            for l in spec.layers:
                for h in rows:
                    calls[("halo_exchange_rows", (1, h // f, w // f, l.in_ch, 1, "mid", 0))] += 1
                if l.pool_after:
                    f *= 2
                if l.unpool_after:
                    f //= 2
    return calls


def pwct_path_calls(pyramid, stages, h, w) -> dict:
    """Launches per kernel of one photo-WCT cascade (no style key) on an (h,
    w) content and style: the plain path's conv3x3 and sum_gram launches;
    ``max_pool_2x2`` only for the style's encoder (the content's pools take
    the argmax pool, plain torch), and no upsample (the decoder unpools)."""
    calls, _ = path_calls(pyramid, stages, h, w)
    counts = Counter()
    for (kernel, _), n in calls.items():
        counts[kernel] += n
    counts["max_pool_2x2"] //= 2
    counts["upsample_nearest_2x"] = 0
    return counts


def work(kernel, shape):
    """(bytes, flops) the function must move and compute: each input read
    once, each output written once, float32."""
    if kernel == "conv3x3_reflect":
        n, h, w, ci, co = shape[:5]
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
            # (N, H, W, Cin, Cout, relu) or with a float offset: an offset
            # leaves a contiguous map that is not 16-byte aligned
            n, h, w, ci, co, relu, *rest = shape
            offset = rest[0] if rest else 0
            x = self.rand(n * h * w * ci + offset)[offset:].view(n, h, w, ci)
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


def profile_cascade(torch, eng, img, sty, label="phase 5", **kw) -> dict:
    """One warm cascade under torch.profiler: device time by kernel name, and
    the card's idle share of that same cascade, 1 - busy / span, with the
    span taken by CUDA events around it (profiler on in both); ``kw`` goes
    to ``stylize_device``."""
    from torch.profiler import ProfilerActivity, profile
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        eng.stylize_device(img, sty, **kw)
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
    # sum_gram's kernels (row or tiled, and the reduce) and conv3x3's (ring
    # templates and the first kernel) by their names
    sg = sum(ms for name, ms in kernels.items() if "sum_gram" in name)
    sg_calls = sum(n for name, n in calls.items() if "sum_gram" in name)
    c3 = sum(ms for name, ms in kernels.items() if CONV3X3_NAMES in name)
    c3_calls = sum(n for name, n in calls.items() if CONV3X3_NAMES in name)
    log(f"{label}: profiled cascade wall {wall_ms:.2f} ms, event span {span_ms:.2f} ms, "
        f"device busy {busy:.2f} ms, idle share {1 - busy / span_ms:.3f}; sum_gram "
        f"{sg:.3f} ms over {sg_calls} CUDA launches; conv3x3_reflect {c3:.3f} ms over "
        f"{c3_calls}; top device time:")
    for name, ms in top:
        log(f"    {ms:8.3f} ms  x{calls[name]:<4d} {name}")
    return {"wall_ms": wall_ms, "span_ms": span_ms, "busy_ms": busy,
            "idle_share": 1 - busy / span_ms, "sum_gram_ms": sg, "conv3x3_ms": c3,
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


# ---- phase 7: the CLIs and the HTTP server ------------------------------------------

def _totals(kc, calls) -> dict:
    """{kernel name: launches} of a plan's {(kernel, shape): count}."""
    return {k.__name__: sum(c for (kernel, _), c in calls.items() if kernel == k.__name__)
            for k in kc.KERNELS}


def _zero(kc) -> None:
    for k in kc.KERNELS:
        k.launches = 0


def _counts(kc) -> dict:
    return {k.__name__: k.launches for k in kc.KERNELS}


def _check_counts(label, got, want) -> None:
    log(f"{label}: launches {got}, predicted {want}")
    if got != want:
        raise AssertionError(f"{label}: launch counts {got} != predicted {want}")


def _http(url, body=None, timeout=600):
    """(status, body, headers) of a GET, or of a POST of ``body``; an HTTP
    error status raises."""
    import urllib.request
    req = urllib.request.Request(url, data=body, method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read(), r.headers


def _legs(headers) -> dict:
    """A response's Server-Timing header as {leg: ms}."""
    return {k: float(v) for k, v in (p.strip().split(";dur=")
                                     for p in headers["Server-Timing"].split(","))}


def _decoded(body, ctype) -> np.ndarray:
    from collaborative_distillation_tpu_torch.data import native_codec as nc
    from collaborative_distillation_tpu_torch.data.png import decode_png
    return decode_png(body) if ctype == "image/png" else nc.decode_jpeg(body)


def _same_as(body, ctype, want, label) -> None:
    """A response or file against the engine's direct uint8 result: a PNG's
    pixels bit-equal, a JPEG's bytes equal to ``encode_jpeg`` of it."""
    from collaborative_distillation_tpu_torch.data import native_codec as nc
    from collaborative_distillation_tpu_torch.data.png import decode_png
    same = (np.array_equal(decode_png(body), want) if ctype == "image/png"
            else body == nc.encode_jpeg(want, quality=95))
    if not same:
        raise AssertionError(f"{label}: differs from the engine's direct call")


def _psnr_u8(torch, a: np.ndarray, b: np.ndarray) -> float:
    """PSNR of two uint8 images, on the card."""
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    return psnr_device(torch, ta.float() / 255.0, tb.float() / 255.0)


class _Server:
    """``build_app(engine)`` on a ThreadingHTTPServer at 127.0.0.1:0, served
    from a thread; the server's log lines are kept in ``logs``."""

    def __init__(self, engine):
        import threading
        from http.server import ThreadingHTTPServer

        from collaborative_distillation_tpu_torch.cli.serve import build_app
        self.logs: list = []
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), build_app(engine, self.logs.append))
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def register(self, name, body, timeout=300) -> str:
        """POST /style/<name> and wait for its warm-up line; returns the
        engine's cache key for it. The warm-up is best-effort in the
        server, so its failure line raises here."""
        _http(f"{self.url}/style/{name}", body)
        t0 = time.time()
        while time.time() - t0 < timeout:
            for line in list(self.logs):
                if line.startswith(f"style '{name}#") and line.endswith("' warm"):
                    return line[len("style '"):-len("' warm")]
                if f"warm-up failed for '{name}#" in line:
                    raise AssertionError(line)
            time.sleep(0.02)
        raise AssertionError(f"style {name!r}: no warm-up line after {timeout} s")

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()


def server_2048(torch, kc, WCTEngine, c2k, s2k) -> dict:
    """7a: the server at 2048^2 (see the module docstring)."""
    from concurrent.futures import ThreadPoolExecutor

    from collaborative_distillation_tpu_torch.data.png import encode_png
    eng = WCTEngine(mode="16x")
    srv = _Server(eng)
    out: dict = {}
    try:
        health = json.loads(_http(srv.url + "/healthz")[1])
        log(f"phase 7a: /healthz {health}")
        if not (health["ok"] and health["device"] == str(eng.device) and health["codec"]):
            raise AssertionError(f"/healthz {health}")
        style_b = np.ascontiguousarray(s2k[:, ::-1])
        t0 = time.perf_counter()
        bodies = {"a": encode_png(s2k), "b": encode_png(style_b), "c": encode_png(c2k)}
        out["png_write_2048_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        ka, kb = srv.register("a", bodies["a"]), srv.register("b", bodies["b"])
        one = _totals(kc, path_calls(eng.pyramid, eng.stages, 2048, 2048, style=False)[0])
        blend_key, proxy = eng.blend_styles([s2k, style_b], [0.7, 0.3], style_keys=[ka, kb])
        wants = {"style=a": eng.stylize(c2k, s2k, style_key=ka, as_uint8=True),
                 "style=a&alpha=0.6": eng.stylize(c2k, s2k, alpha=0.6, style_key=ka,
                                                  as_uint8=True),
                 "style=a:0.7,b:0.3": eng.stylize(c2k, proxy, style_key=blend_key,
                                                  as_uint8=True)}
        out["requests"] = {}
        for query, want in wants.items():
            _zero(kc)
            t0 = time.perf_counter()
            _, body, hdr = _http(f"{srv.url}/stylize?{query}", bodies["c"])
            wall = (time.perf_counter() - t0) * 1e3
            _check_counts(f"phase 7a: POST /stylize?{query}", _counts(kc), one)
            _same_as(body, hdr["Content-Type"], want, f"phase 7a: {query}")
            out["requests"][query] = {"wall_ms": wall, "legs_ms": _legs(hdr),
                                      "type": hdr["Content-Type"], "bytes": len(body)}
            log(f"phase 7a: {query}: {hdr['Content-Type']} {len(body)} B, equal to the "
                f"engine's direct call; client wall {wall:.1f} ms, server split "
                f"{_legs(hdr)} ms")
        # four requests at once from four threads: they queue on the engine lock
        contents = [np.ascontiguousarray(x) for x in (c2k, c2k[::-1], c2k[:, ::-1], c2k[::-1, ::-1])]
        queries = ["style=a", "style=b", "style=a", "style=b"]
        cbodies = [encode_png(c) for c in contents]
        _zero(kc)
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(lambda i: _http(f"{srv.url}/stylize?{queries[i]}", cbodies[i]),
                                range(4)))
        _check_counts("phase 7a: four concurrent requests", _counts(kc),
                      {k: 4 * v for k, v in one.items()})
        for i, (_, body, hdr) in enumerate(got):
            want = eng.stylize(contents[i], s2k if queries[i] == "style=a" else style_b,
                               style_key=ka if queries[i] == "style=a" else kb, as_uint8=True)
            _same_as(body, hdr["Content-Type"], want, f"phase 7a: concurrent request {i}")
        metrics = json.loads(_http(srv.url + "/metrics")[1])
        log(f"phase 7a: the four concurrent responses equal the direct calls; /metrics {metrics}")
        if not (metrics["stylize_requests"] == 7 and metrics["stylize_errors"] == 0
                and metrics["engine_queue"]["max"] >= 2):
            raise AssertionError(f"/metrics {metrics}")
        out["metrics"] = metrics
        log(f"phase 7a: request p50 {metrics['latency_s']['p50'] * 1e3:.0f} ms (server-side, "
            f"7 requests at 2048^2), p95 {metrics['latency_s']['p95'] * 1e3:.0f} ms")
    finally:
        srv.close()
    return out


def server_uhd(torch, kc, WCTEngine, c_uhd, s2k, ref_u8) -> dict:
    """7b: the server at UHD with slab_rows (see the module docstring)."""
    from collaborative_distillation_tpu_torch.data.png import decode_png, encode_png
    from collaborative_distillation_tpu_torch.wct.slab import FEATURE_CACHE_BYTES
    eng = WCTEngine(mode="16x", slab_rows=UHD_SLAB)
    srv = _Server(eng)
    out: dict = {}
    try:
        key = srv.register("s", encode_png(s2k))
        t0 = time.perf_counter()
        body_in = encode_png(c_uhd)
        out["png_write_uhd_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        if not np.array_equal(decode_png(body_in), c_uhd):
            raise AssertionError("UHD PNG round trip")
        out["png_read_uhd_ms"] = (time.perf_counter() - t0) * 1e3
        cached = ("fused", key, (1, 2048, 2048, 3)) in eng._style_cache
        cas = eng.slab
        want = _totals(kc, slab_path_calls(eng.pyramid, eng.stages, cas.margins, cas.slab_rows,
                                           UHD_H, UHD_W, 2048, 2048, FEATURE_CACHE_BYTES,
                                           style=not cached)[0])
        _zero(kc)
        t0 = time.perf_counter()
        _, body, hdr = _http(srv.url + "/stylize?style=s", body_in)
        wall = (time.perf_counter() - t0) * 1e3
        _check_counts(f"phase 7b: POST /stylize {UHD_H}x{UHD_W} (style statistics cached: "
                      f"{cached})", _counts(kc), want)
        t0 = time.perf_counter()
        got = _decoded(body, hdr["Content-Type"])
        read_ms = (time.perf_counter() - t0) * 1e3
        db = _psnr_u8(torch, got, ref_u8)
        out.update(wall_ms=wall, legs_ms=_legs(hdr), type=hdr["Content-Type"],
                   in_bytes=len(body_in), out_bytes=len(body), response_read_ms=read_ms,
                   psnr_vs_phase_3b_db=db)
        log(f"phase 7b: {UHD_H}x{UHD_W} PNG request ({len(body_in)} B, written by the port in "
            f"{out['png_write_uhd_ms']:.0f} ms, read back in {out['png_read_uhd_ms']:.0f} ms): "
            f"{hdr['Content-Type']} {len(body)} B in {wall:.0f} ms client wall; server split "
            f"{_legs(hdr)} ms; response decoded in {read_ms:.0f} ms; vs phase 3b's output "
            f"PSNR {db:.2f} dB (min {PSNR_MIN_DB})")
        if got.shape != c_uhd.shape or not db >= PSNR_MIN_DB:
            raise AssertionError(f"UHD response {got.shape}, {db:.2f} dB")
    finally:
        srv.close()
    return out


def serve_entry_point(c512, s512) -> dict:
    """7c: ``python -m ...cli.serve --port 0`` as a process of its own."""
    import re
    import signal
    import threading

    from collaborative_distillation_tpu_torch.data.png import encode_png
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "collaborative_distillation_tpu_torch.cli.serve",
                             "--mode", "16x", "--port", "0"], cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: list = []
    bound = threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if re.search(r"at http://[\d.]+:\d+ ", line):
                bound.set()
        bound.set()

    threading.Thread(target=read, daemon=True).start()
    try:
        if not bound.wait(300):
            raise AssertionError("cli.serve logged no bound port in 300 s")
        found = [m for m in (re.search(r"at (http://[\d.]+:\d+) ", x) for x in lines) if m]
        if not found:
            raise AssertionError(f"cli.serve exited {proc.poll()}: {lines[-20:]}")
        url, up_s = found[0].group(1), time.perf_counter() - t0
        health = json.loads(_http(url + "/healthz")[1])
        _http(url + "/style/s", encode_png(s512))
        _, body, hdr = _http(url + "/stylize?style=s", encode_png(c512))
        got = _decoded(body, hdr["Content-Type"])
        change = float(np.abs(got.astype(np.float32) - c512).mean()) / 255.0
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
        log(f"phase 7c: cli.serve bound {url} {up_s:.1f} s after start; /healthz {health}; one "
            f"512^2 request: {hdr['Content-Type']} {got.shape}, mean change {change:.4f}; exit "
            f"{rc} after SIGINT; last log line {lines[-1]!r}")
        if not (health["device"].startswith("cuda") and got.shape == c512.shape
                and change > 0.02 and rc == 0):
            raise AssertionError(f"cli.serve: {health}, {got.shape}, change {change}, rc {rc}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"startup_s": up_s, "exit": rc, "type": hdr["Content-Type"]}


def _average_paeth_png(img: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, 3) uint8 image whose rows alternate the
    Average and Paeth filters, as photo writers choose them. Filtering is
    whole-array numpy (each prediction reads the raw bytes); reversing it
    is sequential along a row and takes the port's C helper."""
    import struct
    import zlib

    from collaborative_distillation_tpu_torch.data import png
    h, w, _ = img.shape
    x = img.reshape(h, w * 3).astype(np.int16)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, 3:], b[1:], c[1:, 3:] = x[:, :-3], x[:-1], x[:-1, :-3]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    even = (np.arange(h) % 2 == 0)[:, None]
    rows = np.concatenate([np.where(even, 3, 4), (x - np.where(even, (a + b) // 2, paeth)) % 256],
                          axis=1).astype(np.uint8)
    return (png.PNG_SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + png._chunk(b"IEND", b""))


def stylize_cli(torch, kc, eng, c2k, s2k, c_uhd, ref_u8, expect_uhd, tmp) -> dict:
    """7d: the stylize CLI in process (see the module docstring)."""
    from collaborative_distillation_tpu_torch.cli import stylize as cli
    from collaborative_distillation_tpu_torch.data import png
    from collaborative_distillation_tpu_torch.utils.image import (jpeg_or_png, read_image,
                                                                  save_image)
    out: dict = {}
    contents = {"c1": c2k, "c2": np.ascontiguousarray(c2k[::-1])}
    styles = {"s1": s2k, "s2": np.ascontiguousarray(s2k[:, ::-1])}
    for sub, imgs in (("content", contents), ("style", styles)):
        os.makedirs(os.path.join(tmp, sub))
        for name, img in imgs.items():
            save_image(img, os.path.join(tmp, sub, name + ".png"))
    # c2 as a file with Average and Paeth rows: the CLI reads it through the
    # C helper, built here with g++ at first use
    with open(os.path.join(tmp, "content", "c2.png"), "wb") as f:
        f.write(_average_paeth_png(contents["c2"]))
    t0 = time.perf_counter()
    with open(os.path.join(tmp, "content", "c2.png"), "rb") as f:
        same = np.array_equal(png.decode_png(f.read()), contents["c2"])
    log(f"phase 7d: a 2048^2 PNG with Average and Paeth rows read back equal: {same} in "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms (C helper built into {png.build_dir()}: "
        f"{png._lib is not None})")
    if not (same and png._lib is not None):
        raise AssertionError(f"Average/Paeth PNG: equal {same}, helper {png._reason}")
    both = _totals(kc, path_calls(eng.pyramid, eng.stages, 2048, 2048)[0])
    one = _totals(kc, path_calls(eng.pyramid, eng.stages, 2048, 2048, style=False)[0])
    # four pairs, each style encoded at its first pair and cached for the second
    want = {k: 2 * both[k] + 2 * one[k] for k in both}
    prof = os.path.join(tmp, "profile")
    _zero(kc)
    t0 = time.perf_counter()
    cli.main(["--mode", "16x", "--contentPath", os.path.join(tmp, "content"), "--stylePath",
              os.path.join(tmp, "style"), "--outf", os.path.join(tmp, "out"), "--log_mark", "g",
              "--profile", prof])
    out["grid_s"] = time.perf_counter() - t0
    _check_counts("phase 7d: stylize CLI, 2 x 2 pairs at 2048^2 (stylize_pairs)", _counts(kc),
                  want)
    for c, s in ((c, s) for c in contents for s in styles):
        path, _ = jpeg_or_png(os.path.join(tmp, "out", f"g_mode=16x_alpha=1.0_{c}+{s}.jpg"))
        with open(path, "rb") as f:
            _same_as(f.read(), "image/png" if path.endswith(".png") else "image/jpeg",
                     eng.stylize(contents[c], styles[s], as_uint8=True), f"phase 7d: {path}")
    with open(os.path.join(prof, "trace.json")) as f:
        named = CONV3X3_NAMES in f.read()
    log(f"phase 7d: the four files (*{os.path.splitext(path)[1]}) equal the engine's outputs; "
        f"{out['grid_s']:.2f} s with the profiler on; its trace names {CONV3X3_NAMES}: {named}")
    if not named:
        raise AssertionError(f"--profile trace does not name {CONV3X3_NAMES}")
    # one UHD pair: stylize(as_uint8=True), the streamed tail
    for sub, img in (("uhd_content", c_uhd), ("uhd_style", s2k)):
        os.makedirs(os.path.join(tmp, sub))
        save_image(img, os.path.join(tmp, sub, "u.png"))
    _zero(kc)
    t0 = time.perf_counter()
    cli.main(["--mode", "16x", "--UHD", "--UHD_contentPath", os.path.join(tmp, "uhd_content"),
              "--UHD_stylePath", os.path.join(tmp, "uhd_style"), "--slab_rows", str(UHD_SLAB),
              "--outf", os.path.join(tmp, "out"), "--log_mark", "u"])
    out["uhd_s"] = time.perf_counter() - t0
    _check_counts(f"phase 7d: stylize CLI, one {UHD_H}x{UHD_W} pair --slab_rows {UHD_SLAB}",
                  _counts(kc), expect_uhd)
    path, _ = jpeg_or_png(os.path.join(tmp, "out", "u_mode=16x_alpha=1.0_u+u.jpg"))
    db = _psnr_u8(torch, read_image(path), ref_u8)
    out["uhd_psnr_vs_phase_3b_db"] = db
    log(f"phase 7d: UHD pair in {out['uhd_s']:.2f} s (PNG read and written by the port "
        f"included) -> {os.path.basename(path)}, vs phase 3b's output PSNR {db:.2f} dB "
        f"(min {PSNR_MIN_DB})")
    if not db >= PSNR_MIN_DB:
        raise AssertionError(f"stylize CLI UHD pair {db:.2f} dB")
    return out


def eval_cli(c512, s512, tmp) -> dict:
    """7e: the eval CLI on four 256^2 crops, on the card and on the CPU."""
    from collaborative_distillation_tpu_torch.cli import eval as cli
    from collaborative_distillation_tpu_torch.utils.image import save_image
    os.makedirs(os.path.join(tmp, "eval"))
    for i, img in enumerate((c512[:256, :256], c512[256:, 256:], s512[:256, 256:],
                             s512[256:, :256])):
        save_image(np.ascontiguousarray(img), os.path.join(tmp, "eval", f"{i}.png"))
    argv = ["--mode", "16x", "--images", os.path.join(tmp, "eval"), "--size", "256",
            "--n_images", "4"]
    t0 = time.perf_counter()
    card = cli.run(argv)
    card_s = time.perf_counter() - t0
    cpu = cli.run(argv + ["--device", "cpu"])
    worst = {k: (abs(card[k]["psnr"] - cpu[k]["psnr"]), abs(card[k]["ssim"] - cpu[k]["ssim"]))
             for k in card}
    log(f"phase 7e: eval on the card ({card_s:.2f} s) {card}; |card - cpu| per stage (PSNR dB, "
        f"SSIM) {worst} (max 0.05, 1e-3)")
    if not all(d <= 0.05 and e <= 1e-3 for d, e in worst.values()):
        raise AssertionError(f"eval card vs cpu {worst}")
    return {"card": card, "cpu": cpu}


def teacher_widths(torch, kc, WCTEngine, c512, s512, tmp) -> dict:
    """7f: a seeded ``original`` pyramid (teacher widths, Cin/Cout to 512)."""
    from collaborative_distillation_tpu_torch.cli import stylize as cli
    from collaborative_distillation_tpu_torch.models.vgg import (apply_decoder, apply_encoder,
                                                                 init_params)
    from collaborative_distillation_tpu_torch.models.zoo import stage_specs
    from collaborative_distillation_tpu_torch.utils.image import (jpeg_or_png, read_image,
                                                                  save_image)
    root = os.path.join(tmp, "weights")
    os.makedirs(os.path.join(root, "original"))
    gen = torch.Generator().manual_seed(0)
    for k in (5, 4, 3, 2, 1):
        for spec, name in zip(stage_specs("original", k), (f"e{k}", f"d{k}")):
            p = init_params(spec, gen)
            np.savez(os.path.join(root, "original", name + ".npz"),
                     **{f"{n}/{kind}": t.numpy() for n, leaf in p.items()
                        for kind, t in leaf.items()})
    teng = WCTEngine(mode="original", weights_root=root)
    tpyr = teng.pyramid
    calls, layers = path_calls(tpyr, teng.stages, 512, 512)
    bench = Bench(torch, tpyr)
    checks = [bench.run(kernel, shape, layers.get(shape)) for kernel, shape in
              sorted(calls, key=str)]
    widest = max(s[3] for kernel, s in calls if kernel == "conv3x3_reflect")
    worst_conv = max(r["max_rel_err"] for r in checks if r["kernel"] == "conv3x3_reflect")
    # each stage's encoder + decoder on a 64^2 crop, card vs the plain path on the CPU
    cpu = WCTEngine(mode="original", weights_root=root, device="cpu")
    x = np.ascontiguousarray(c512[:64, :64], np.float32)[None] / 255.0
    chain = {}
    with torch.inference_mode():
        for k in teng.stages:
            card, plain = (apply_decoder(e.pyramid[k]["dec"], apply_encoder(
                e.pyramid[k]["enc"], torch.from_numpy(x).to(e.device),
                e.pyramid[k]["enc_spec"], aux=False)["out"], e.pyramid[k]["dec_spec"])["out"].cpu()
                for e in (teng, cpu))
            chain[k] = float((card - plain).abs().max() / (plain.abs().max() + 1e-30))
    log(f"phase 7f: seeded original pyramid (conv3x3 up to Cin {widest}): {len(checks)} "
        f"kernel-vs-plain checks at its 512^2 path shapes passed (conv3x3 max err "
        f"{worst_conv:.3e} of the largest partial sum, tol {CONV_TOL}); encoder+decoder card vs "
        f"cpu max rel err by stage {chain} (tol 1e-4)")
    if not max(chain.values()) <= 1e-4:
        raise AssertionError(f"teacher encoder+decoder card vs cpu {chain}")
    for sub, img in (("t_content", c512), ("t_style", s512)):
        os.makedirs(os.path.join(tmp, sub))
        save_image(img, os.path.join(tmp, sub, "p.png"))
    _zero(kc)
    t0 = time.perf_counter()
    cli.main(["--weights_root", root, "--contentPath", os.path.join(tmp, "t_content"),
              "--stylePath", os.path.join(tmp, "t_style"), "--outf", os.path.join(tmp, "t_out"),
              "--log_mark", "t"])   # --mode original: the CLI's default
    cli_s = time.perf_counter() - t0
    _check_counts("phase 7f: stylize CLI --mode original, one 512^2 pair", _counts(kc),
                  _totals(kc, calls))
    path, _ = jpeg_or_png(os.path.join(tmp, "t_out", "t_mode=original_alpha=1.0_p+p.jpg"))
    with open(path, "rb") as f:
        _same_as(f.read(), "image/png" if path.endswith(".png") else "image/jpeg",
                 teng.stylize(c512, s512, as_uint8=True), "phase 7f: the CLI's file")
    card_f = teng.stylize(c512, s512)
    db = psnr(card_f, cpu.stylize(c512, s512))
    log(f"phase 7f: CLI in {cli_s:.2f} s, its file equals the engine's uint8 output; float "
        f"output finite: {bool(np.isfinite(card_f).all())}, range [{card_f.min():.3f}, "
        f"{card_f.max():.3f}]; card vs cpu PSNR {db:.2f} dB (random weights: not gated)")
    if not np.isfinite(card_f).all():
        raise AssertionError("teacher-width cascade output is not finite")
    return {"checks": len(checks), "widest_cin": widest, "conv_max_rel_err": worst_conv,
            "chain_rel_err": chain, "cli_s": cli_s, "card_vs_cpu_db": db}


# ---- phase 8: training ----------------------------------------------------------

TRAIN_STAGE, TRAIN_N, TRAIN_HW = 5, 16, 256   # cli.train's full width: stage 5 x 16 x 256^2
TRAIN_STEPS = 6
TRAIN_IMAGES = 48
# hand-written kernels, by the profiler's names; cuDNN's convolution kernels
# by theirs (every forward conv3x3 of the step is ours, so these are the
# backward's; "cf32" is the complex GEMM of its FFT convolutions); cuBLAS's
# GEMMs (conv0's and the aux adapters' x @ w, forward and backward) on their own
OUR_KERNEL_NAMES = (CONV3X3_NAMES, "max_pool_2x2_kernel", "upsample_nearest_2x_kernel")
CUDNN_CONV_NAMES = ("dgrad", "wgrad", "fprop", "cudnn", "convolve", "implicit_gemm", "fft",
                    "cf32")
GEMM_NAMES = ("gemm", "cutlass")


def _grad_close(got, want, scale, tol, label) -> float:
    """max |got - want| over max |scale|; raises over ``tol``."""
    err = float((got - want).abs().max()) / max(float(scale.abs().max()), 1e-30)
    if not err <= tol:
        raise AssertionError(f"{label}: gradient error {err:.3e} of the largest partial sum "
                             f"> {tol}")
    return err


def train_autograd_checks(torch) -> dict:
    """8a: the kernels' autograd Functions against the plain versions'
    autograd on the card, TF32 off, at the training path's shapes (stage-5
    teacher and student widths, N = 16, 256^2 -> 16^2) and edge shapes."""
    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    from collaborative_distillation_tpu_torch.ops import conv as tconv
    from collaborative_distillation_tpu_torch.ops.cuda import conv as kconv
    from collaborative_distillation_tpu_torch.ops.cuda import pool as kpool
    from collaborative_distillation_tpu_torch.train.trainer import full_float32
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(8)
    rand = lambda *s: torch.rand(s, generator=gen, device="cuda")
    convs, pools, ups = set(), set(), set()
    for fam in ("original", "16x"):
        hh = TRAIN_HW
        for l in encoder_spec(fam, TRAIN_STAGE, aux=fam == "16x").layers:
            convs.add((TRAIN_N, hh, hh, l.in_ch, l.out_ch, l.relu))
            if l.pool_after:
                pools.add((TRAIN_N, hh, hh, l.out_ch))
                hh //= 2
        for l in decoder_spec(fam, TRAIN_STAGE).layers:
            convs.add((TRAIN_N, hh, hh, l.in_ch, l.out_ch, l.relu))
            if l.unpool_after:
                ups.add((TRAIN_N, hh, hh, l.out_ch))
                hh *= 2
    path = len(convs)
    convs |= {(1, 1, 1, 16, 16, True), (2, 7, 9, 24, 32, True), (1, 1, 5, 3, 3, False),
              (1, 3, 2, 64, 64, True), (3, 17, 5, 512, 256, True)}
    pools |= {(1, 7, 9, 16), (2, 3, 5, 8), (1, 2, 2, 3)}
    ups |= {(1, 1, 1, 8), (2, 3, 5, 16)}
    worst, worst_fwd, flips = 0.0, 0.0, 0
    with full_float32():
        for n, h, w, ci, co, relu in sorted(convs):
            x = rand(n, h, w, ci).requires_grad_()
            wt = ((rand(3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)).requires_grad_()
            b = (rand(co) - 0.5).requires_grad_()
            g = rand(n, h, w, co) - 0.5
            y = tconv.conv3x3(x, wt, b, relu=relu)
            got = torch.autograd.grad(y, (x, wt, b), g)
            gp = g
            with torch.no_grad():
                # the forward: the Function's output and, under a ReLU, the
                # kernel's pre-activation, against the plain version to
                # CONV_TOL of the largest partial sum (as phase 2)
                plain = kconv.conv3x3_plain(x, wt, b, False)
                fscale = float(x.abs().max() * wt.abs().sum(dim=(0, 1, 2)).max() + b.abs().max())
                pairs = [(y, plain.clamp_min(0) if relu else plain)]
                if relu:
                    pre = kconv.conv3x3_reflect(x, wt, b, False)
                    pairs.append((pre, plain))
                for a, r in pairs:
                    err = float((a - r).abs().max()) / fscale
                    if not err <= CONV_TOL:
                        raise AssertionError(f"conv3x3 forward at {(n, h, w, ci, co, relu)}: "
                                             f"{err:.3e} of the largest partial sum > {CONV_TOL}")
                    worst_fwd = max(worst_fwd, err)
                if relu:
                    # the plain version's autograd under the kernel's own ReLU
                    # decisions: a pre-activation within rounding of 0 may take
                    # the other side in the two forwards (a kink, not a fault);
                    # at most RELU_FLIP_SHARE of the outputs may
                    nflip = int(((pre > 0) != (plain > 0)).sum())
                    if nflip > max(2, RELU_FLIP_SHARE * pre.numel()):
                        raise AssertionError(f"conv3x3 at {(n, h, w, ci, co, relu)}: {nflip} "
                                             f"of {pre.numel()} ReLU decisions differ")
                    flips += nflip
                    gp = g * torch.where(pre > 0, 1.0, torch.where(pre == 0, 0.5, 0.0))
                    del pre
                del plain, pairs
            want = torch.autograd.grad(kconv.conv3x3_plain(x, wt, b, False), (x, wt, b), gp)
            ab = [t.detach().abs().requires_grad_() for t in (x, wt, b)]
            scale = torch.autograd.grad(kconv.conv3x3_plain(*ab, False), ab, g.abs())
            for a, r, sc, name in zip(got, want, scale, "xwb"):
                worst = max(worst, _grad_close(a, r, sc, CONV_TOL,
                                               f"conv3x3 d{name} at {(n, h, w, ci, co, relu)}"))
            del x, wt, b, g, gp, y, got, want, ab, scale
        # whole numbers in [0, 2]: ties in most windows, sums exact
        for shape in sorted(pools):
            x = torch.floor(rand(*shape) * 3).requires_grad_()
            y = tconv.max_pool_2x2(x)
            g = torch.floor(rand(*y.shape) * 7) - 3
            got = torch.autograd.grad(y, x, g)[0]
            want = torch.autograd.grad(F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(
                0, 2, 3, 1), x, g)[0]
            if not (torch.equal(got, want) and torch.equal(y, kpool.max_pool_2x2_plain(x.detach()))):
                raise AssertionError(f"max_pool_2x2 gradient at {shape}: not the first maximum's")
        x = torch.ones(2, 8, 8, 4, device="cuda", requires_grad=True)   # every window tied
        got = torch.autograd.grad(tconv.max_pool_2x2(x).sum(), x)[0]
        if not torch.equal(got[:, 0::2, 0::2], torch.ones_like(got[:, 0::2, 0::2])) \
                or float(got.sum()) != 2 * 4 * 4 * 4:
            raise AssertionError("max_pool_2x2 ties: the gradient is not at each first maximum")
        for shape in sorted(ups):
            x = rand(*shape).requires_grad_()
            g = torch.floor(rand(shape[0], 2 * shape[1], 2 * shape[2], shape[3]) * 7) - 3
            y = tconv.upsample_nearest_2x(x)
            got = torch.autograd.grad(y, x, g)[0]
            want = torch.autograd.grad(kpool.upsample_nearest_2x_plain(x), x, g)[0]
            if not (torch.equal(got, want)
                    and torch.equal(y, kpool.upsample_nearest_2x_plain(x.detach()))):
                raise AssertionError(f"upsample_nearest_2x forward or gradient at {shape}")
        # pre-activations exactly 0: JAX's subgradient, exactly half
        x = rand(2, 9, 7, 32)
        wt = torch.zeros(3, 3, 32, 64, device="cuda", requires_grad=True)
        b = torch.zeros(64, device="cuda", requires_grad=True)
        g = rand(2, 9, 7, 64) - 0.5
        gw, gb = torch.autograd.grad(tconv.conv3x3(x, wt, b, relu=True), (wt, b), g)
        lin = torch.autograd.grad(kconv.conv3x3_plain(x, wt, b, False), wt, g)[0]
        if not torch.equal(gb, (0.5 * g).sum(dim=(0, 1, 2))):
            raise AssertionError("ReLU at 0 on the card: bias gradient is not 0.5 g")
        _grad_close(gw, 0.5 * lin, lin, CONV_TOL, "conv3x3 dw at a ReLU tie")
    out = {"conv_shapes": len(convs), "path_conv_shapes": path, "pool_shapes": len(pools),
           "upsample_shapes": len(ups), "conv_max_rel_err": worst,
           "conv_forward_max_rel_err": worst_fwd, "relu_flips": flips}
    log(f"phase 8a: autograd Functions vs the plain versions (TF32 off): "
        f"{len(convs)} conv3x3 shapes ({path} of the stage-5 N={TRAIN_N} {TRAIN_HW}^2 path, "
        f"teacher and student widths), forward max err {worst_fwd:.3e}, gradients max err "
        f"{worst:.3e} of the largest partial sum (tol {CONV_TOL}; ReLUs under the kernel's "
        f"pre-activations, {flips} of which take the other side in the plain forward, limit "
        f"{RELU_FLIP_SHARE} of a shape's outputs); {len(pools)} pool and {len(ups)} upsample "
        f"shapes exact, forward and gradient (ties: the first maximum); ReLU at 0 passes "
        f"exactly 0.5 g")
    return out


def train_card_vs_cpu(torch) -> dict:
    """8b: one step of each mode on the card against the same step on the
    CPU: stage 2, N = 2, 64^2, the same seeded weights and batch."""
    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    from collaborative_distillation_tpu_torch.models.vgg import init_params
    from collaborative_distillation_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                                    student_spec)
    out = {}
    batch = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    for mode in ("wct_se", "wct_sd", "wct_sd_kd2sd"):
        gen = torch.Generator().manual_seed(0)
        frozen = {"be": init_params(encoder_spec("original", 2), gen),
                  "bd": init_params(decoder_spec("original", 2), gen),
                  "se": init_params(encoder_spec("16x", 2, aux=True), gen)}
        cfg = TrainConfig(mode=mode, stage=2)
        student = init_params(student_spec(cfg), gen)
        card, cpu = (Trainer(cfg, student, frozen, device=d) for d in ("cuda", "cpu"))
        lc, _ = card.train_step(batch)
        lp, _ = cpu.train_step(batch)
        loss_err = max(abs(float(lc[k]) - float(lp[k])) / abs(float(lp[k])) for k in lp)
        grad_err = step_err = 0.0
        for name, leaf in cpu.params.items():
            for kind, t in leaf.items():
                gc = card.params[name][kind].grad.cpu()
                grad_err = max(grad_err, float((gc - t.grad).abs().max())
                               / max(float(t.grad.abs().max()), 1e-30))
                # Adam's first update, lr g / (|g| + eps), where |g| is over
                # 1e-3 of the leaf's max (nearer 0 it may step the other way)
                strong = t.grad.abs() >= 1e-3 * t.grad.abs().max()
                du = card.params[name][kind].detach().cpu() - t.detach()
                step_err = max(step_err, float(du[strong].abs().max()) / cfg.lr)
        frozen_none = all(t.grad is None for tr in (card, cpu) for f in tr.frozen.values()
                          for leaf in f.values() for t in leaf.values())
        out[mode] = {"loss_rel_err": loss_err, "grad_rel_err": grad_err,
                     "update_err_lr": step_err, "frozen_grad_none": frozen_none}
        if not (loss_err <= 1e-5 and grad_err <= 1e-4 and step_err <= 1e-3 and frozen_none):
            raise AssertionError(f"phase 8b {mode}: card vs cpu {out[mode]}")
    log(f"phase 8b: one step card vs cpu (stage 2, N=2, 64^2): " + "; ".join(
        f"{m} losses {r['loss_rel_err']:.2e} rel, student grads {r['grad_rel_err']:.2e} of "
        f"max|g|, updates {r['update_err_lr']:.2e} lr, frozen grads None"
        for m, r in out.items()) + " (tol 1e-5, 1e-4, 1e-3)")
    return out


def _train_runs(mode: str) -> list:
    """The stage-5 encoder and decoder passes of one training step, in order."""
    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    k = TRAIN_STAGE
    be, bd = encoder_spec("original", k), decoder_spec("original", k)
    se, sd = encoder_spec("16x", k, aux=True), decoder_spec("16x", k)   # aux: 1x1, no kernel
    return {"wct_se": [se, bd, be, be], "wct_sd": [se, sd],
            "wct_sd_kd2sd": [be, se, bd, sd, be]}[mode]


def _train_launches(mode: str) -> dict:
    """Kernel launches of one training step at stage 5, from the specs: every
    forward conv3x3, pool and upsample (the backward launches none)."""
    runs = _train_runs(mode)
    return {"conv3x3_reflect": sum(len(s.layers) for s in runs),
            "max_pool_2x2": sum(sum(l.pool_after for l in s.layers) for s in runs),
            "upsample_nearest_2x": sum(sum(l.unpool_after for l in s.layers) for s in runs)}


def _train_kernel_bound_ms(mode: str) -> float:
    """The least time the card could take for one step's hand-written kernels:
    each conv3x3's FLOPs at the FP32 peak or its bytes at the HBM rate, the
    larger, summed, plus the pools' and upsamples' bytes."""
    total = 0.0
    for spec in _train_runs(mode):
        hh = TRAIN_HW if spec.kind == "encoder" else TRAIN_HW >> (TRAIN_STAGE - 1)
        for l in spec.layers:
            nbytes, flops = work("conv3x3_reflect", (TRAIN_N, hh, hh, l.in_ch, l.out_ch))
            total += max(nbytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS)
            if l.pool_after or l.unpool_after:
                kernel = "max_pool_2x2" if l.pool_after else "upsample_nearest_2x"
                total += work(kernel, (TRAIN_N, hh, hh, l.out_ch))[0] / PEAK_BYTES
                hh = hh // 2 if l.pool_after else hh * 2
    return total * 1e3


class _StepProbe:
    """Wraps ``Trainer.train_step`` for a CLI run in process: per step its
    wall time (synchronised), its kernel launches (counters zeroed around
    it), its losses; keeps the trainer and the last batch."""

    def __init__(self, torch, kc, trainer_cls):
        self.torch, self.kc, self.cls = torch, kc, trainer_cls
        self.orig = trainer_cls.train_step
        self.steps, self.trainer, self.batch, self.aux_grad = [], None, None, None

    def __enter__(self):
        probe = self

        def step(trainer, batch):
            torch = probe.torch
            torch.cuda.synchronize()
            _zero(probe.kc)
            t0 = time.perf_counter()
            losses, rec = probe.orig(trainer, batch)
            torch.cuda.synchronize()
            probe.steps.append({"s": time.perf_counter() - t0, "launches": _counts(probe.kc),
                                "losses": {k: float(v) for k, v in losses.items()}})
            if probe.aux_grad is None:
                probe.aux_grad = {n: float(leaf["w"].grad.abs().max())
                                  for n, leaf in trainer.params.items() if "aux" in n}
            probe.trainer, probe.batch = trainer, batch
            return losses, rec

        self.cls.train_step = step
        return self

    def __exit__(self, *exc):
        self.cls.train_step = self.orig


def _profile_step(torch, trainer, batch) -> dict:
    """One more step of ``trainer`` under torch.profiler: its busy device
    time split into the hand-written kernels, cuDNN's backward and the rest,
    and the device time under each backward node (``Conv3x3Backward``, ...)."""
    from torch.profiler import ProfilerActivity, profile
    trainer.train_step(batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    split, top, nodes = Counter(), Counter(), Counter()
    node = "autograd::engine::evaluate_function: "
    for e in prof.key_averages():
        if e.key.startswith(node):
            nodes[e.key[len(node):]] += getattr(e, "device_time_total", 0.0) / 1e3
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            ms = getattr(e, "self_device_time_total", 0.0) / 1e3
            if ms <= 0:
                continue
            top[e.key[:80]] += ms
            key = e.key.lower()
            part = ("kernels" if any(n in e.key for n in OUR_KERNEL_NAMES) else
                    "cudnn_backward" if any(n in key for n in CUDNN_CONV_NAMES) else
                    "gemm" if any(n in key for n in GEMM_NAMES) else "rest")
            split[part] += ms
    busy = sum(split.values())
    return {"busy_ms": busy, **{f"{k}_ms": split[k] for k in ("kernels", "cudnn_backward",
                                                                "gemm", "rest")},
            "top_ms": dict(top.most_common(8)), "backward_nodes_ms": dict(nodes.most_common(8))}


def _write_training_pngs(torch, c512, s512, folder) -> None:
    """TRAIN_IMAGES PNG crops of the reflect-tiled photo pair, shorter side
    300 to 420."""
    from collaborative_distillation_tpu_torch.utils.image import save_image
    os.makedirs(folder)
    rng = np.random.default_rng(0)
    tiles = [reflect_tile(torch, c512, 1024), reflect_tile(torch, s512, 1024)]
    for i in range(TRAIN_IMAGES):
        h, w = (int(v) for v in rng.integers(300, 421, 2))
        y, x = (int(v) for v in rng.integers(0, 1024 - 420, 2))
        save_image(np.ascontiguousarray(tiles[i % 2][y:y + h, x:x + w]),
                   os.path.join(folder, f"{i:02d}.png"))


def train_cli_runs(torch, kc, c512, s512, tmp, teachers) -> dict:
    """8c: ``cli.train`` in process at stage 5 x 16 x 256^2, f32: wct_se and
    wct_sd_kd2sd against phase 9c's teacher store (``teachers``, written by
    ``cli.make_teacher`` on the card), wct_sd --lw_perc 0 on the shipped
    weights alone; each with its launches per step, checkpoint keys, a
    resume, step times, peak memory and one profiled step."""
    import shutil

    from collaborative_distillation_tpu_torch.cli import train as cli
    from collaborative_distillation_tpu_torch.models.zoo import default_weights_root
    from collaborative_distillation_tpu_torch.train.trainer import Trainer
    k = TRAIN_STAGE
    shipped = default_weights_root()
    root = os.path.join(tmp, "train_weights")
    shutil.copytree(os.path.join(teachers, "original"), os.path.join(root, "original"))
    shutil.copytree(os.path.join(shipped, "16x_base"), os.path.join(root, "16x_base"))
    data = os.path.join(tmp, "train_images")
    _write_training_pngs(torch, c512, s512, data)
    runs = {
        "wct_se": ["--mode", "wct_se", "--pretrained_init", "--weights_root", root],
        "wct_sd": ["--mode", "wct_sd", "--lw_perc", "0", "--pretrained_init"],
        "wct_sd_kd2sd": ["--mode", "wct_sd_kd2sd", "--pretrained_init", "--weights_root", root,
                         "--SD", os.path.join(shipped, "16x_base", f"d{k}.npz"),
                         "--updim_relu"],
    }
    common = ["--stage", str(k), "-b", str(TRAIN_N), "--content_train", data, "--cache_data",
              "--device", "cuda",
              "--print_interval", "1", "--save_interval", "100"]
    out = {}
    cwd = os.getcwd()
    os.chdir(tmp)   # the CLI writes Experiments/ in its working directory
    try:
        for mode, argv in runs.items():
            torch.cuda.reset_peak_memory_stats()
            with _StepProbe(torch, kc, Trainer) as probe:
                t0 = time.perf_counter()
                cli.main(argv + common + ["--max_steps", str(TRAIN_STEPS), "-p", mode])
                wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            steps = probe.steps
            want = {**{kk.__name__: 0 for kk in kc.KERNELS}, **_train_launches(mode)}
            _check_counts(f"phase 8c: {mode}, one step", steps[0]["launches"], want)
            for i, st in enumerate(steps):
                if st["launches"] != want:
                    raise AssertionError(f"phase 8c: {mode} step {i + 1} launches "
                                         f"{st['launches']} != {want}")
                if not all(np.isfinite(v) for v in st["losses"].values()):
                    raise AssertionError(f"phase 8c: {mode} step {i + 1} losses {st['losses']}")
            (run_dir,) = [d for d in os.listdir("Experiments") if d.endswith("_" + mode)]
            wdir = os.path.join("Experiments", run_dir, "weights")
            (ckpt,) = [os.path.join(wdir, f) for f in os.listdir(wdir) if f.endswith(".npz")]
            with np.load(ckpt) as z:
                keys = set(z.files)
            layers = probe.trainer.params
            want_keys = ({f"params/{n}/{kk}" for n in layers for kk in ("w", "b")}
                         | {f"opt_state/0/{i}/{n}/{kk}" for i in (1, 2) for n in layers
                            for kk in ("w", "b")}
                         | {"opt_state/0/0", "meta/epoch", "meta/step", "meta/mode",
                            "meta/stage"})
            if keys != want_keys:
                raise AssertionError(f"phase 8c: {mode} checkpoint keys {sorted(keys ^ want_keys)}")
            prof = _profile_step(torch, probe.trainer, probe.batch)
            times = [st["s"] for st in steps[1:]]
            med = statistics.median(times)
            # resume: 48 images at batch 16 are 3 steps an epoch, so the run
            # ended after epoch 2 and the resumed one starts epoch 3
            with _StepProbe(torch, kc, Trainer) as again:
                cli.main(argv + common + ["--max_steps", "1", "--epoch", "3", "--resume", ckpt,
                                          "-p", mode + "_resumed"])
            (rdir,) = [d for d in os.listdir("Experiments") if d.endswith(mode + "_resumed")]
            rlog = open(os.path.join("Experiments", rdir, "weights", [
                f for f in os.listdir(os.path.join("Experiments", rdir, "weights"))
                if f.startswith("log_")][0])).read()
            if "at epoch 2" not in rlog or "E3S0" not in rlog or len(again.steps) != 1:
                raise AssertionError(f"phase 8c: {mode} --resume did not continue at epoch 3")
            prof["kernels_bound_ms"] = _train_kernel_bound_ms(mode)
            out[mode] = {"steps_s": [st["s"] for st in steps], "median_s": med,
                         "images_per_s": TRAIN_N / med, "peak_gib": peak, "wall_s": wall,
                         "launches_per_step": want, "losses_first": steps[0]["losses"],
                         "losses_last": steps[-1]["losses"], "aux_grad_max": probe.aux_grad,
                         "profile": prof, "resumed_losses": again.steps[0]["losses"]}
            log(f"phase 8c: cli.train {mode} stage {k} x {TRAIN_N} x {TRAIN_HW}^2: "
                f"{len(steps)} steps, median step {med * 1e3:.1f} ms over steps 2-{len(steps)} "
                f"({TRAIN_N / med:.2f} images/s; steps {', '.join(f'{t * 1e3:.0f}' for t in times)} "
                f"ms), peak {peak:.2f} GiB, wall {wall:.1f} s; losses first "
                f"{steps[0]['losses']}, last {steps[-1]['losses']}; checkpoint keys in the "
                f"reference's layout ({len(keys)}); --resume continued at epoch 3")
            if not prof["busy_ms"]:
                log(f"phase 8c: {mode}: the profiler saw no device time: split not measured")
            log(f"phase 8c: {mode} profiled step: busy {prof['busy_ms']:.1f} ms = hand-written "
                f"kernels {prof['kernels_ms']:.1f} (bound {prof['kernels_bound_ms']:.1f}) + cuDNN "
                f"backward convs {prof['cudnn_backward_ms']:.1f} + cuBLAS GEMMs "
                f"{prof['gemm_ms']:.1f} + rest {prof['rest_ms']:.1f}; backward nodes: " + "; ".join(
                    f"{n} {ms:.1f}" for n, ms in prof["backward_nodes_ms"].items())
                + "; top kernels: " + "; ".join(
                    f"{n} {ms:.1f}" for n, ms in prof["top_ms"].items()))
        aux = out["wct_sd_kd2sd"]["aux_grad_max"]
        log(f"phase 8c: wct_sd_kd2sd --updim_relu from zero-filled aux adapters: first-step "
            f"max|grad w| {aux}")
        if not aux or not all(v > 0 for v in aux.values()):
            raise AssertionError(f"phase 8c: zero aux adapters got no gradient {aux}")
    finally:
        os.chdir(cwd)
    return out


def training(torch, kc, c512, s512, tmp, teachers) -> dict:
    """Phase 8: the training path (8a, 8b, 8c), with its own clock;
    ``teachers``: phase 9c's store."""
    t0 = time.perf_counter()
    out = {"autograd": train_autograd_checks(torch), "card_vs_cpu": train_card_vs_cpu(torch),
           "cli": train_cli_runs(torch, kc, c512, s512, tmp, teachers)}
    out["phase8_s"] = time.perf_counter() - t0
    log(f"phase 8: {out['phase8_s']:.1f} s")
    return out


# ---- phase 9: photo-WCT, the cascade function, the teacher store, small modules --

def nvjpeg_presence() -> dict:
    """Phase 1: whether the CUDA toolkit ships nvJPEG, ``include/nvjpeg.h``
    and ``lib64/libnvjpeg.so*`` under ``CUDA_HOME`` or nvcc's parent.
    Records only; builds nothing."""
    import glob

    from collaborative_distillation_tpu_torch.ops.cuda import _build
    home = os.environ.get("CUDA_HOME") or os.path.dirname(
        os.path.dirname(os.path.realpath(_build._nvcc())))
    header = os.path.join(home, "include", "nvjpeg.h")
    libs = sorted(glob.glob(os.path.join(home, "lib64", "libnvjpeg.so*")))
    out = {"cuda_home": home, "header": os.path.exists(header), "libs": libs}
    log(f"phase 1: nvJPEG in the CUDA toolkit at {home}: include/nvjpeg.h "
        f"{'present' if out['header'] else 'absent'}; lib64/libnvjpeg.so* "
        f"{', '.join(os.path.basename(x) for x in libs) if libs else 'absent'}")
    return out


def unpooled_conv_checks(torch, kc, pyr, stages, h, w) -> list:
    """Phase 2: conv3x3 against its plain version at every decoder conv of
    the photo-WCT cascade that reads a max-unpooled map (three of every four
    values exactly 0), with the decoder's weights, at an (h, w) cascade;
    each timed beside its plain version and cuDNN's reflect conv (one call a
    cascade each)."""
    from collaborative_distillation_tpu_torch.ops.conv import (max_pool_2x2_with_argmax,
                                                                max_unpool_2x2)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    with torch.inference_mode():
        for k in stages:
            spec, params = pyr[k]["dec_spec"], pyr[k]["dec"]
            hh, ww = h >> (k - 1), w >> (k - 1)
            after_unpool = False
            for l in spec.layers:
                if after_unpool:
                    src = torch.rand((1, hh, ww, l.in_ch), generator=gen, device="cuda")
                    x = max_unpool_2x2(*max_pool_2x2_with_argmax(src), (hh, ww))
                    wt, b = params[l.name]["w"].contiguous(), params[l.name]["b"].contiguous()
                    got = kc.conv3x3_reflect(x, wt, b, l.relu)
                    ref = kc.conv3x3_reflect.plain(x, wt, b, l.relu)
                    scale = float(x.abs().max() * wt.abs().sum(dim=(0, 1, 2)).max()
                                  + b.abs().max())
                    err = float((got - ref).abs().max())
                    zeros = float((x == 0).float().mean())
                    rows.append({"kernel": "conv3x3_reflect", "unpooled": True,
                                 "shape": [1, hh, ww, l.in_ch, l.out_ch, l.relu],
                                 "zero_share": zeros, "max_abs_err": err,
                                 "max_rel_err": err / scale, "tol": CONV_TOL * scale,
                                 "ok": err <= CONV_TOL * scale})
                    if not err <= CONV_TOL * scale:
                        raise AssertionError(f"conv3x3 on an unpooled map {rows[-1]['shape']}: "
                                             f"error {err} > {CONV_TOL * scale}")
                    lib = torch.nn.Conv2d(l.in_ch, l.out_ch, 3, padding=1,
                                          padding_mode="reflect", device="cuda")
                    lib.weight.copy_(wt.permute(3, 2, 0, 1))
                    lib.bias.copy_(b)
                    xn = x.permute(0, 3, 1, 2)
                    nbytes, flops = work("conv3x3_reflect", rows[-1]["shape"])
                    rows[-1].update(
                        calls=1, ms=cuda_ms(torch, lambda: kc.conv3x3_reflect(x, wt, b, l.relu), 10),
                        plain_ms=cuda_ms(torch, lambda: kc.conv3x3_reflect.plain(x, wt, b, l.relu),
                                         10),
                        library_ms=cuda_ms(torch, lambda: lib(xn), 10),
                        bytes_ms=nbytes / PEAK_BYTES * 1e3, flops_ms=flops / PEAK_FP32_FLOPS * 1e3)
                after_unpool = l.unpool_after
                if l.unpool_after:
                    hh, ww = hh * 2, ww * 2
    return rows


def pwct_shared_indices(torch, eng, eng_cpu, c, s) -> dict:
    """Phase 9a: photo-WCT card vs CPU with the card's pool indices fed to
    both decoders. Alone, each device's argmax may break a near-tie in a
    2x2 window another way and move a whole patch through the later stages,
    which would hide a small conv error. Per stage, on the card's input:
    the encoder's output, and the decoder's on the card's WCT features and
    indices, card vs CPU to STAGE_TOL. Then the whole cascade, each device
    on its own inputs and statistics but with the card's indices, as PSNR
    after the crop and clip; and the card's side equal to the engine's
    ``stylize(pwct=True)``."""
    from collaborative_distillation_tpu_torch.models.vgg import (apply_decoder_pwct,
                                                                 apply_encoder)
    from collaborative_distillation_tpu_torch.ops.wct_transform import wct_transform
    h, w = c.shape[:2]
    enc_err = dec_err = 0.0
    with torch.inference_mode():
        img, sty = eng._prep(c), eng._prep(s)
        img_cpu, sty_cpu = img.cpu(), sty.cpu()
        a_card, a_cpu = torch.tensor(1.0, device="cuda"), torch.tensor(1.0)
        for k in eng.stages:
            p, q = eng.pyramid[k], eng_cpu.pyramid[k]
            es, ds = p["enc_spec"], p["dec_spec"]
            f = apply_encoder(p["enc"], img, es, aux=False, with_pool_argmax=True)
            idx = {n: v.cpu() if torch.is_tensor(v) else v
                   for n, v in f.items() if n.startswith("pool")}
            enc_err = max(enc_err, rel_err(
                f["out"].cpu(), apply_encoder(q["enc"], img.cpu(), es, aux=False)["out"]))
            sm, sc = eng._style_stats(k, sty)
            csf = wct_transform(f["out"], sm, sc, a_card, method=eng.method,
                                newton_iters=eng.newton_iters)
            img = apply_decoder_pwct(p["dec"], csf, ds, f)
            dec_err = max(dec_err, rel_err(img.cpu(),
                                           apply_decoder_pwct(q["dec"], csf.cpu(), ds, idx)))
            g = apply_encoder(q["enc"], img_cpu, es, aux=False)["out"]
            sm, sc = eng_cpu._style_stats(k, sty_cpu)
            img_cpu = apply_decoder_pwct(q["dec"], wct_transform(
                g, sm, sc, a_cpu, method=eng_cpu.method, newton_iters=eng_cpu.newton_iters),
                ds, idx)
        card = torch.clamp(img[0, :h, :w], 0.0, 1.0).cpu().numpy()
        cpu = torch.clamp(img_cpu[0, :h, :w], 0.0, 1.0).numpy()
    engine_err = float(np.abs(card - eng.stylize(c, s, pwct=True)).max())
    return {"encoder_max_rel_err": enc_err, "decoder_max_rel_err": dec_err,
            "psnr_db": psnr(card, cpu), "engine_max_abs": engine_err}


def photo_wct(torch, kc, eng, eng_cpu, slab_eng, shard_eng, c2k, s2k, c512, s512) -> dict:
    """Phase 9a: ``stylize(pwct=True)`` at 2048^2 with the launch counters
    zeroed (the specs' prediction), finite and unlike ``pwct=False``; the
    512^2 pair on the card against the CPU engine; the warm median of 5 and
    peak memory; the slab and sharded engines refuse it."""
    names = [k.__name__ for k in kc.KERNELS]
    want = pwct_path_calls(eng.pyramid, eng.stages, 2048, 2048)
    want = {n: want[n] for n in names}
    _zero(kc)
    t0 = time.perf_counter()
    out = eng.stylize(c2k, s2k, pwct=True)
    first_s = time.perf_counter() - t0
    counts = _counts(kc)
    _check_counts("phase 9a: stylize(pwct=True) 2048^2", counts, want)
    plain = eng.stylize(c2k, s2k)
    change = float(np.abs(out - plain).mean())
    if not (out.shape == c2k.shape and np.isfinite(out).all() and change > 0.01):
        raise AssertionError(f"phase 9a: photo-WCT output shape {out.shape}, finite "
                             f"{np.isfinite(out).all()}, mean |pwct - plain| {change}")
    shared = pwct_shared_indices(torch, eng, eng_cpu, c512, s512)
    if not (shared["encoder_max_rel_err"] <= STAGE_TOL
            and shared["decoder_max_rel_err"] <= STAGE_TOL
            and shared["psnr_db"] >= PSNR_MIN_DB and shared["engine_max_abs"] <= CACHE_TOL):
        raise AssertionError(f"phase 9a: 512^2 photo-WCT card vs cpu, indices shared: {shared}")
    # each device's own indices: a figure, not a gate (argmax flips)
    db = psnr(eng.stylize(c512, s512, pwct=True), eng_cpu.stylize(c512, s512, pwct=True))
    with torch.inference_mode():
        img, sty = eng._prep(c2k), eng._prep(s2k)
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.stylize_device(img, sty, pwct=True)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2**30
        eng.stylize_device(img, sty, pwct=True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = profile_cascade(torch, eng, img, sty, "phase 9a", pwct=True)
        del img, sty
    refused = []
    for label, e in (("slab", slab_eng), ("sharded", shard_eng)):
        try:
            e.stylize(c512, s512, pwct=True)
        except ValueError as err:
            if "pwct=True is only supported" in str(err):
                refused.append(label)
                continue
            raise
        raise AssertionError(f"phase 9a: the {label} engine ran pwct=True")
    log(f"phase 9a: stylize(pwct=True) 2048^2 in {first_s:.3f} s (first call, host transfer "
        f"included); launches {counts}, predicted {want}; mean |pwct - plain| {change:.4f}; "
        f"512^2 card vs cpu with the card's pool indices: encoders max rel err "
        f"{shared['encoder_max_rel_err']:.3e}, decoders {shared['decoder_max_rel_err']:.3e} "
        f"(tol {STAGE_TOL}), cascade {shared['psnr_db']:.2f} dB (min {PSNR_MIN_DB}), its card "
        f"side vs stylize(pwct=True) max abs {shared['engine_max_abs']:.3e} (tol {CACHE_TOL}); "
        f"each device's own indices {db:.2f} dB (argmax flips; no bar); warm "
        f"{statistics.median(runs):.2f} ms (runs {', '.join(f'{r:.2f}' for r in runs)}), "
        f"peak {peak:.2f} GiB ({resident:.2f} GiB held before it); refused by the "
        f"{' and '.join(refused)} engines")
    return {"launches": counts, "first_s": first_s, "mean_change_vs_plain": change,
            "psnr_512_card_vs_cpu_db": db, "card_vs_cpu_shared_indices": shared,
            "runs_ms": runs,
            "median_ms": statistics.median(runs), "peak_gib": peak,
            "resident_before_gib": resident, "refused_by": refused, "profile": prof}


def cascade_fn_check(torch, eng, c2k, s2k) -> dict:
    """Phase 9b: ``stylize_cascade_fn`` at 2048^2 against the engine's
    unclipped output: the same kernels on the same inputs."""
    from collaborative_distillation_tpu_torch.wct.engine import stylize_cascade_fn
    with torch.inference_mode():
        img, sty = eng._prep(c2k), eng._prep(s2k)
        got = stylize_cascade_fn(eng.pyramid, stages=eng.stages)(eng.pyramid, img, sty, 1.0)
        want = eng._run(img, sty, 1.0, num_run=1, style_key=None)
        err = float((got - want).abs().max())
    log(f"phase 9b: stylize_cascade_fn 2048^2 vs the engine's unclipped output: max abs "
        f"{err:.3e} (tol {CACHE_TOL})")
    if not err <= CACHE_TOL:
        raise AssertionError(f"phase 9b: stylize_cascade_fn vs engine {err}")
    return {"max_abs": err}


def teacher_store(torch, tmp) -> dict:
    """Phase 9c: ``python -m ...cli.make_teacher --out <tmp>`` on the card
    (stages 1-5, the synthetic calibration), timed; each stage's
    calibration re-run on the written store (every filter not floored at
    mean activation 1 within 1e-3, the floored ones found from their means
    before normalization); a stage-2 ``normalize_encoder`` on the
    card against the CPU on the same params and batches (1e-4 of each
    leaf's largest magnitude). Returns the store's root for phase 8c."""
    from collaborative_distillation_tpu_torch.cli.make_teacher import synth_calibration_batches
    from collaborative_distillation_tpu_torch.cli.normalize_vgg import (_layer_mean,
                                                                        normalize_encoder)
    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    from collaborative_distillation_tpu_torch.models.vgg import init_params
    from collaborative_distillation_tpu_torch.models.zoo import PREPROC_CONV0, load_stage_params
    root = os.path.join(tmp, "teacher_store")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "collaborative_distillation_tpu_torch.cli.make_teacher",
                           "--out", root], cwd=HERE, capture_output=True, text=True)
    build_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"phase 9c: make_teacher exited {proc.returncode}:\n"
                             f"{proc.stdout}{proc.stderr}")
    batches = synth_calibration_batches(16, 4, 128, 0)
    # the floored filters, from the means before normalization: the store's
    # bias is the drawn one over the filter's floored mean, so the drawn
    # biases (make_teacher's seed-0 draws, encoder then decoder per stage)
    # give that mean back as (store's mean) x (drawn b / store's b); a
    # filter is floored where it lies under 1e-2 (make_teacher's rel_floor)
    # of its layer's average, and every other filter is held to 1
    gen = torch.Generator().manual_seed(0)
    worst, floored, total = 0.0, 0, 0
    with torch.inference_mode():
        xs = [torch.from_numpy(b).cuda() for b in batches]
        for k in range(1, 6):
            spec = encoder_spec("original", k)
            drawn = init_params(spec, gen)
            init_params(decoder_spec("original", k), gen)
            params = load_stage_params(os.path.join(root, "original", f"e{k}.npz"), spec,
                                       "cuda")
            for layer in spec.layers:
                m = (sum(_layer_mean(params, spec, x, layer.name).double() * x.shape[0]
                         for x in xs) / sum(x.shape[0] for x in xs)).cpu().numpy()
                clamped = (drawn[layer.name]["b"].double()
                           / params[layer.name]["b"].cpu().double()).numpy()
                if not (clamped > 0).all():
                    raise AssertionError(f"phase 9c: {layer.name} of stage {k}: the store's "
                                         f"biases are not the seed-0 draws rescaled")
                before = m * clamped
                low = before < 1e-2 * before.mean()
                floored, total = floored + int(low.sum()), total + low.size
                worst = max(worst, float(np.abs(m[~low] - 1.0).max()))
    if not worst <= 1e-3:
        raise AssertionError(f"phase 9c: a filter's mean activation is {worst} from 1")
    spec2 = encoder_spec("original", 2)
    raw = init_params(spec2, torch.Generator().manual_seed(7))
    raw["conv0"] = {kind: torch.from_numpy(a) for kind, a in PREPROC_CONV0.items()}
    cal = synth_calibration_batches(8, 4, 128, 1)
    card = normalize_encoder({n: {kk: t.cuda() for kk, t in leaf.items()}
                              for n, leaf in raw.items()}, spec2, cal)
    cpu = normalize_encoder(raw, spec2, cal)
    leaf_err = max(float((card[n][kk].cpu() - cpu[n][kk]).abs().max())
                   / float(cpu[n][kk].abs().max()) for n in cpu for kk in cpu[n])
    if not leaf_err <= 1e-4:
        raise AssertionError(f"phase 9c: normalize_encoder card vs cpu {leaf_err}")
    log(f"phase 9c: cli.make_teacher stages 1-5 on the card in {build_s:.1f} s (a new "
        f"process: interpreter, imports and the card's start included); every filter not "
        f"floored at mean activation 1 within {worst:.2e} (tol 1e-3; {floored} of {total} "
        f"floored, by their means before normalization); "
        f"stage-2 normalize_encoder card vs cpu max leaf rel err {leaf_err:.2e} (tol 1e-4)")
    return {"root": root, "build_s": build_s, "unit_mean_max_err": worst,
            "floored_filters": floored, "filters": total, "normalize_card_vs_cpu": leaf_err,
            "log": proc.stdout.strip().splitlines()}


def small_modules(torch, eng, c512) -> dict:
    """Phase 9d: ``apply_mobilenet_encoder`` at stages 1-5 on a seeded
    synthetic state dict at 512^2, and ``gram_matrix`` and ``adain`` on a
    stage-3 feature map, on the card against the CPU (1e-5 of the largest
    output)."""
    from torch import nn

    from collaborative_distillation_tpu_torch.models.mobilenet import (
        MOBILENET_BLOCKS, apply_mobilenet_encoder, convert_mobilenet_state_dict)
    from collaborative_distillation_tpu_torch.models.vgg import apply_encoder
    from collaborative_distillation_tpu_torch.ops.style_stats import adain, gram_matrix

    def block(cin, cout, stride, first):
        if first:
            return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, 1, bias=False),
                                 nn.BatchNorm2d(cout), nn.ReLU())
        return nn.Sequential(nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False),
                             nn.BatchNorm2d(cin), nn.ReLU(), nn.Conv2d(cin, cout, 1, bias=False),
                             nn.BatchNorm2d(cout), nn.ReLU())

    torch.manual_seed(0)
    model = nn.Sequential(*(block(*b, i == 0) for i, b in enumerate(MOBILENET_BLOCKS)))
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            with torch.no_grad():
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.3, 0.3)
    sd = {f"module.model.{k}": v for k, v in model.state_dict().items()}
    x = torch.from_numpy(c512.astype(np.float32) / 255.0)[None]
    out = {"mobilenet": {}}
    with torch.inference_mode():
        for stage in range(1, 6):
            tree = convert_mobilenet_state_dict(sd, stage)
            card = apply_mobilenet_encoder(tree, x.cuda(), stage)["out"].cpu()
            cpu = apply_mobilenet_encoder(tree, x, stage)["out"]
            out["mobilenet"][stage] = rel_err(card, cpu.double())
            # each device's own distance from float64, so a zero above is two
            # float32 results that agree, not one result read twice
            ref64 = apply_mobilenet_encoder(tree, x.double(), stage)["out"]
            out.setdefault("mobilenet_vs_float64", {})[stage] = (rel_err(card, ref64),
                                                                  rel_err(cpu, ref64))
        p = eng.pyramid[3]
        feat = apply_encoder(p["enc"], x.cuda(), p["enc_spec"], aux=False)["out"]
        sfeat = feat.flip(1).contiguous()
        out["gram"] = rel_err(gram_matrix(feat).cpu(), gram_matrix(feat.cpu()).double())
        out["adain"] = rel_err(adain(feat, sfeat).cpu(),
                               adain(feat.cpu(), sfeat.cpu()).double())
    worst = max(max(out["mobilenet"].values()), out["gram"], out["adain"])
    log(f"phase 9d: card vs cpu max rel err: apply_mobilenet_encoder 512^2 stages 1-5 "
        + ", ".join(f"{k}: {v:.2e} (card / cpu vs float64 {a:.2e} / {c:.2e})"
                    for (k, v), (a, c) in zip(out["mobilenet"].items(),
                                              out["mobilenet_vs_float64"].values()))
        + f"; gram_matrix {out['gram']:.2e}, adain {out['adain']:.2e} on the stage-3 map "
        f"{tuple(feat.shape)} (tol 1e-5)")
    if not worst <= 1e-5:
        raise AssertionError(f"phase 9d: card vs cpu {out}")
    return out


def main() -> int:
    global PEAK_FP32_FLOPS
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from collaborative_distillation_tpu_torch.utils.flops import card_peak_flops, cascade_flops
    PEAK_FP32_FLOPS, peak_label = card_peak_flops(0, "float32")
    if not PEAK_FP32_FLOPS:
        print(f"chip_smoke: no FP32 peak for {peak_label} in utils/flops.py:CARD_PEAKS; "
              f"the bounds need one", file=sys.stderr)
        return 1
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
    detail["nvjpeg"] = nvjpeg_presence()

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
    per_conv = WCTEngine(mode="16x", space=SHARDS, devices=["cuda:0"] * SHARDS)
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
             (1, 16, 16, 512, 512, True), (1, 9, 9, 128, 3, False),
             # (..., float offset): one past each ring template's tile both
             # ways, off 16-byte alignment; H or W of 2; W no multiple of the
             # 8-pixel strip
             (1, 9, 17, 128, 128, True, 1), (1, 17, 17, 64, 64, True, 3),
             (1, 17, 33, 32, 32, False, 1), (1, 17, 33, 3, 24, True, 1),
             (1, 33, 33, 16, 16, True, 2), (1, 33, 65, 16, 3, False, 1),
             (1, 33, 65, 24, 3, True, 0), (1, 2, 2, 128, 64, True, 0),
             (2, 2, 13, 16, 16, True, 1), (1, 13, 2, 32, 16, False, 0),
             (1, 37, 45, 64, 128, True, 1)]]
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
              (2, 4, 5, 3, 24, False, True, 0), (1, 3, 11, 128, 8, True, False, 2),
              # one past a pixel tile of each Cout class, off 16-byte
              # alignment; many tiles a block (the ring wraps)
              (1, 1, 257, 24, 24, False, True, 1), (1, 1, 257, 32, 32, False, True, 2),
              (1, 1, 257, 64, 64, False, True, 3), (1, 1, 129, 128, 128, False, True, 1),
              (1, 3, 100001, 24, 24, False, True, 1)]]
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
    # the per-conv sharded path at 2000 rows: shards of unequal heights (whole
    # 16-row blocks, the remainder on the last), one exchange per conv; and
    # photo-WCT's decoder convs on max-unpooled maps (3 of 4 values 0)
    awk_rows = per_conv._block_rows(PC_AWK_H)
    pc_calls = per_conv_halo_calls(pyr, eng.stages, awk_rows, 2048)
    pc_rows = []
    for (kernel, shape), n in sorted(pc_calls.items(), key=str):
        pc_rows.append({**bench.run(kernel, shape, timed=True), "calls": n})
    unpooled = unpooled_conv_checks(torch, kc, pyr, eng.stages, 2048, 2048)
    checks += pc_rows + unpooled
    detail["per_conv_awkward_halo"] = {"shard_rows": awk_rows, "launches": sum(pc_calls.values()),
                                       **path_times(pc_rows)}
    detail["unpooled_conv3x3"] = {"launches": len(unpooled), **path_times(unpooled)}
    log(f"phase 2: the per-conv sharded path at {PC_AWK_H}x2048 (shard rows {awk_rows}): "
        f"{len(pc_rows)} halo shapes, exact; a cascade's "
        f"{detail['per_conv_awkward_halo']['launches']} exchanges "
        f"{detail['per_conv_awkward_halo']['ms']:.3f} ms (bound "
        f"{detail['per_conv_awkward_halo']['bound_ms']:.3f}, plain "
        f"{detail['per_conv_awkward_halo']['plain_ms']:.3f}, torch.cat "
        f"{detail['per_conv_awkward_halo']['library_ms']:.3f}); conv3x3 on "
        f"{len(unpooled)} max-unpooled 2048^2 decoder maps "
        f"({min(r['zero_share'] for r in unpooled):.3f}+ zeros): max rel err "
        f"{max(r['max_rel_err'] for r in unpooled):.3e} (tol {CONV_TOL}), "
        f"{detail['unpooled_conv3x3']['ms']:.3f} ms a cascade (bound "
        f"{detail['unpooled_conv3x3']['bound_ms']:.3f}, plain "
        f"{detail['unpooled_conv3x3']['plain_ms']:.3f}, cuDNN "
        f"{detail['unpooled_conv3x3']['library_ms']:.3f})")
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
    if not worst <= STAGE_TOL:
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
    ref_uhd_u8 = (np.clip(out_uhd, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)   # phase 7's yardstick
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
        db_pc = psnr_device(torch, per_conv.stylize_device(img2k, sty2k),
                            eng.stylize_device(img2k, sty2k))
        pc_halos = kc.halo_exchange_rows.launches - before
        # rows past a multiple of 16 * space, in the content and in the style:
        # whole 16-row blocks, the style's statistics taken whole
        db_awk_c = psnr_device(torch, per_conv.stylize_device(img2k[:, :PC_AWK_H], sty2k),
                               eng.stylize_device(img2k[:, :PC_AWK_H], sty2k))
        db_awk_s = psnr_device(torch, per_conv.stylize_device(img2k, sty2k[:, :PC_AWK_H]),
                               eng.stylize_device(img2k, sty2k[:, :PC_AWK_H]))
    # one exchange per conv of the content's encoder and the decoder, and shard
    pc_expect = sum(per_conv_halo_calls(pyr, eng.stages, [2048 // SHARDS] * SHARDS,
                                        2048).values())
    log(f"phase 4c: UHD sharded (space={SHARDS}, slab_rows={SHARD_SLAB}) vs the single-card "
        f"slab cascade at the same slab size PSNR {db_sh:.2f} dB; 2048^2 per-conv sharded "
        f"vs plain {db_pc:.2f} dB; {PC_AWK_H}x2048 content {db_awk_c:.2f} dB, {PC_AWK_H}x2048 "
        f"style {db_awk_s:.2f} dB (min {PSNR_MIN_DB}); per-conv halo launches {pc_halos}, "
        f"predicted {pc_expect}")
    detail["sharded_vs_single"] = {"uhd_psnr_db": db_sh, "per_conv_2048_psnr_db": db_pc,
                                   "per_conv_halo_launches": pc_halos,
                                   "per_conv_awkward_content_psnr_db": db_awk_c,
                                   "per_conv_awkward_style_psnr_db": db_awk_s}
    if not (min(db_sh, db_pc, db_awk_c, db_awk_s) >= PSNR_MIN_DB and pc_halos == pc_expect):
        raise AssertionError(f"sharded vs single-card: UHD {db_sh:.2f} dB, per-conv "
                             f"{db_pc:.2f} / {db_awk_c:.2f} / {db_awk_s:.2f} dB, halo "
                             f"launches {pc_halos} != {pc_expect}")

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
    from collaborative_distillation_tpu_torch.ops.cuda.conv import device_plan
    rows = []
    for (kernel, shape), n in sorted(calls2k.items(), key=str):
        r = bench.run(kernel, shape, layers2k.get(shape), timed=True)
        r["calls"] = n
        rows.append(r)
        if kernel == "conv3x3_reflect":
            r["plan"] = device_plan(*shape[:5], 0).kernel
            log(f"phase 5: conv3x3_reflect {shape[:5]} x{n} plan {r['plan']}: "
                f"{r['ms']:.4f} ms, bound {max(r['bytes_ms'], r['flops_ms']):.4f}, plain "
                f"{r['plain_ms']:.4f}, cuDNN {r['library_ms']:.4f}")
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
    by_plan = Counter()   # conv3x3's ms per 2048^2 cascade by the template that ran
    for r in rows:
        if r.get("plan"):
            by_plan[r["plan"]] += r["ms"] * r["calls"]
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
            **({"uhd_slab": sg_uhd} if name == "sum_gram" else {}),
            **({"by_plan_ms": dict(by_plan)} if name == "conv3x3_reflect" else {})})
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
    # the utilization's workload is cascade_flops', which leaves out the
    # style's encoders and statistics (cached per style, a server's steady
    # state): time it with the style's statistics cached, warm median of 5
    with torch.inference_mode():
        eng.stylize_device(img, sty, style_key="phase 5")
        cached = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.stylize_device(img, sty, style_key="phase 5")
            torch.cuda.synchronize()
            cached.append((time.perf_counter() - t0) * 1e3)
    flops = cascade_flops("16x", 2048, 2048)
    tflops = flops / (statistics.median(cached) / 1e3) / 1e12
    detail["cascade_2048_ms"].update(cached_style_runs=cached,
                                     cached_style_median=statistics.median(cached),
                                     flops=flops, tflops=tflops,
                                     share_of_fp32_peak=tflops * 1e12 / PEAK_FP32_FLOPS)
    log(f"phase 5: 2048^2 cascade with the style's statistics cached warm "
        f"{statistics.median(cached):.2f} ms (runs {', '.join(f'{r:.2f}' for r in cached)}); "
        f"its {flops / 1e12:.4f} TFLOP (utils/flops.py:cascade_flops, no style leg) over "
        f"that median: {tflops:.2f} TFLOP/s, {tflops * 1e12 / PEAK_FP32_FLOPS:.1%} of the "
        f"card's FP32 peak ({peak_label}, {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s)")
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
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        # ---- phase 9: photo-WCT, the cascade function, the teacher store ---------
        t9 = time.perf_counter()
        detail["photo_wct"] = photo_wct(torch, kc, eng, eng_cpu, slab_eng, shard_eng, c2k, s2k,
                                        c512, s512)
        detail["cascade_fn"] = cascade_fn_check(torch, eng, c2k, s2k)
        detail["teacher_store"] = teacher_store(torch, tmp)
        detail["small_modules"] = small_modules(torch, eng, c512)
        detail["phase9_s"] = time.perf_counter() - t9
        # ---- phase 7: the CLIs and the server --------------------------------------
        t7 = time.perf_counter()
        detail["server_2048"] = server_2048(torch, kc, WCTEngine, c2k, s2k)
        detail["server_uhd"] = server_uhd(torch, kc, WCTEngine, c_uhd, s2k, ref_uhd_u8)
        detail["serve_entry_point"] = serve_entry_point(c512, s512)
        detail["stylize_cli"] = stylize_cli(torch, kc, eng, c2k, s2k, c_uhd, ref_uhd_u8,
                                            expect_uhd, tmp)
        detail["eval_cli"] = eval_cli(c512, s512, tmp)
        detail["teacher_widths"] = teacher_widths(torch, kc, WCTEngine, c512, s512, tmp)
        detail["phase7_s"] = time.perf_counter() - t7
        # ---- phase 8: training ---------------------------------------------------------
        detail["training"] = training(torch, kc, c512, s512, tmp,
                                      detail["teacher_store"]["root"])
    detail["total_s"] = time.perf_counter() - t_start
    log(f"phase 9: {detail['phase9_s']:.1f} s; phase 7: {detail['phase7_s']:.1f} s; phase 8: "
        f"{detail['training']['phase8_s']:.1f} s; chip_smoke.py {detail['total_s']:.1f} s "
        f"(kernel build included)")
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
