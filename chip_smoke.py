#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one GPU and hold every kernel against
its plain PyTorch version.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a) and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card, the versions, and the build of the CUDA kernels from
     ``collaborative_distillation_tpu_torch/ops/cuda/csrc``; whether the CUDA
     toolkit ships nvJPEG (``include/nvjpeg.h``, ``lib64/libnvjpeg.so*``),
     and beside the kernels the build of the nvJPEG shim from
     ``collaborative_distillation_tpu_torch/data/csrc/nvjpeg_codec.cpp``, its
     link line and the libnvjpeg the process mapped: the script fails where
     nvJPEG does not load;
  2. each kernel against its plain version on the card, at every distinct
     shape of the mode-16x cascade at 512^2 and of the UHD slab cascade,
     the plain UHD cascade's largest conv map, plus edge shapes (1-pixel maps, odd sizes, C not a multiple of 4,
     unaligned slices; for both convs one past each template's pixel tile,
     off 16-byte alignment); ``halo_exchange_rows`` and ``halo_fill_rows``
     exactly, at every launch of the sharded UHD path (the first stage's
     exchange of the card's four shards, each later stage's fill) and at
     edge shapes (one row, the whole neighbour, N = 2, odd row sizes, offset
     slices, one to five shards a launch, the shard's own reflection rows as
     sources); conv3x3 with halo rows (the
     per-conv sharded path's conv, staging its neighbours' boundary rows) at
     every shape of that path at 2000 x 2048 (shards of unequal heights),
     timed against the same conv reflecting its own rows and against
     ``torch.cat`` of the extended shard, and at edge shapes (one row,
     ragged tiles of every template, N = 2, rows off 16-byte alignment, a
     null side); conv3x3 on every max-unpooled map of the 2048^2 photo-WCT decoders (3
     of 4 values 0); conv3x3 at the teachers' widths (Cin or Cout 256/512,
     the Cout-walking ring template) at every such shape of a wct_se step
     (phase 8d) and of the original cascade at 512^2 and 1024^2 (phase 7f),
     and with halo rows at their pairs; the SHA-256 of the conv3x3 outputs
     at the 2048^2 path's shapes (seeded inputs: equal across checkouts
     whose kernels compute the same bits there); a 16x16 image (relu5_1 at 1x1) stylizes to all-NaN
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
     (one ``halo_exchange_rows`` launch at the first stage, which extends
     the card's four shards whole, and one ``halo_fill_rows`` launch before
     each later stage, which fills only the halo rows of the extended shards
     the stage before decoded into). With two or more cards the halo
     checks and this phase run once more across cards (one exchange and one
     fill a stage on each card); with one a line says that no cross-card run
     was made;
  4. the card's 512^2 output against the same engine on the CPU (PSNR);
  4b. the UHD slab output against the plain per-stage cascade on the card
     (PSNR), a 2048^2 slab run (``slab_rows=512``) against the plain one,
     and the feature cache on against off;
  4c. the sharded UHD output against the single-card fused slab cascade at
     the same slab size (PSNR), and the per-conv sharded cascade (``space=4``
     without ``slab_rows``: whole 16-row blocks per shard, the style's
     statistics taken whole) against the plain one at 2048^2, at a 2000 x
     2048 content and at a 2000 x 2048 style, each with the counters zeroed:
     no ``halo_exchange_rows`` launch and as many conv3x3 halo launches
     (``conv3x3_reflect.halo_launches``) as the plan's halo convs;
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
  5c. ``halo_exchange_rows`` and ``halo_fill_rows`` at the sharded UHD
     launches beside the bound, their plain versions, ``torch.cat`` of the
     extended shards (the exchange at every stage that the fill replaced)
     and the same rows by ``copy_``/``zero_``, on the device and by
     events, summed per cascade; the warm sharded UHD cascade
     (median of 3), its peak memory and profile;
  5d. the warm per-conv sharded cascade (``space=4`` on the one card) at
     2048^2 and at 2000 x 2048: median of 5, device busy and idle share,
     peak memory and launches;
  5e. ``packed`` (each encoder's ``conv0`` folded into its ``conv1_1``, the
     engine's default on the slab paths) against ``packed=False``: the UHD
     slab cascade (``slab_rows=1024``) and the slab-in-shard one (``space=4``,
     ``slab_rows=512`` on the one card), float32 and bf16, the style's
     statistics cached: folded vs unfolded PSNR (float32 at PSNR_MIN_DB; bf16
     each held to the float32 folded output, below), warm medians of 3 in
     turns, spreads, peaks, idle shares, and the ``conv0`` products the
     profiler records (``x @ w`` with a 3x3 matrix): none folded, the plan's
     (20 slab, 80 slab-in-shard) unfolded; conv3x3 and its bf16 ``ck8_*``
     templates against their plain versions with each stage's folded
     ``conv1_1`` on its first UHD window;
  6. the host boundary: (a) nvJPEG against libjpeg's decodes in
     ``data/jpeg_fixture.npz`` (4:2:0 planes to NVJPEG_PLANE_MAX levels, RGB
     of 4:2:0, 4:4:4, progressive, odd-sized and grey files at PSNR_MIN_DB),
     its q95 tables against the IJG ones, both encoders' q95 files of the
     same planes decoded on the card, nvJPEG's decode and encode walls at
     2048^2 and UHD and its own memory; ``stylize_jpeg`` on a UHD 4:2:0 JPEG
     made from the photo pair by nvJPEG, with the counters zeroed (the slab
     plan's counts), its bytes and ``stylize_planes_jpeg``'s equal to
     ``stylize_planes(on_device=True)`` + ``encode_jpeg_yuv420``, the host
     planes of the streamed tail within a level of the device ones; (b)
     ``stylize_planes`` at UHD against the RGB transport (Y plane PSNR); (c)
     uint8 host-to-host walls at 2048^2 and UHD for ``transport="rgb"`` and
     ``"yuv420"``, and ``push`` through pinned staging at several chunk sizes
     against a pageable ``.to()``; (d) ``stylize_pairs`` over four 2048^2
     uint8 pairs, bit-equal to four ``stylize`` calls, and both walls;
  7. the CLIs and the HTTP server (``collaborative_distillation_tpu_torch/cli``),
     bodies and files written and read by the port (PNG; JPEG by nvJPEG),
     each launch count read with the counters zeroed around
     one request or CLI run and held to the plan's, the style's statistics
     cached or not: (a) ``build_app(WCTEngine(mode="16x"))`` on a local
     ThreadingHTTPServer, two registered 2048^2 styles (warm log lines
     awaited), requests at alpha 1 and 0.6, a blend and four concurrent ones,
     each response equal to the engine's direct call (PNG pixels bit-equal, or
     JPEG bytes equal to the card's ``encode_jpeg`` of it), ``/metrics`` (7
     requests, 0 errors, a queue of 2 or more), the p50 and the
     decode/cascade/encode split, then JPEG_REQUESTS JPEG bodies one at a
     time (``image/jpeg``, the plan's launches, the first equal to the direct
     call, client p50/p95 and the split); (b) a ``slab_rows=1024`` server,
     one 4096 x 10240 PNG request against phase 3b's output (PSNR) and three
     JPEG ones (``image/jpeg``, launches, walls, split, PSNR at
     JPEG_PSNR_MIN_DB); (c) ``python -m ...cli.serve --port 0``
     as a process: the bound port from its log, one 512^2 request, exit 0
     after SIGINT; (d) the stylize CLI in process over 2 x 2 pairs at 2048^2,
     one style a ``.jpg`` written and read back by nvJPEG, the outputs
     ``.jpg`` (``stylize_pairs``; the files equal the engine's outputs; ``--profile``
     writes a trace that names the conv3x3 kernel) and one UHD pair with
     ``--slab_rows 1024`` against phase 3b's output; (e) the eval CLI on four
     256^2 crops, on the card against ``--device cpu``; (f) a seeded
     ``original`` pyramid (teacher widths, Cin/Cout to 512): every kernel at
     its 512^2 path shapes against the plain version, each stage's encoder
     and decoder card vs CPU, the stylize CLI at its default ``--mode
     original`` on one 512^2 pair, and the warm original cascade at 1024^2
     (median of 3, peak memory, one run's launches by conv3x3 template:
     none on the first kernel);
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
     epoch, the first batch's loss falling over 1 + 8 steps from the run's
     initial masters, nonzero gradients into the zero-filled aux adapters,
     the median step time, images/s, peak memory and one profiled step's
     split into the hand-written kernels, cuDNN's backward and the rest;
     (d) conv3x3 at a
     wct_se step's 27 teacher-width convs against cuDNN's FP32 forward and
     the bound; no conv of the step may plan the first kernel; (e) bf16
     mixed-precision training (``TrainConfig(compute_dtype="bfloat16")``,
     ``cli.train --bf16``), with its own clock: (a) the three Functions in
     bf16 against the plain versions' autograd at every conv, pool and
     upsample shape of the three bf16 steps (N = 16, teacher widths
     included): forwards within one bf16 ulp, gradients within
     ``BF16_GRAD`` (below), pool and upsample exact; (b) one bf16 step of
     each mode card vs CPU; (c) ``cli.train --bf16`` for the three modes
     as in (c), launches per step on the bf16 kernels only, float32
     masters and Adam state, the f32 run's checkpoint keys, ``--resume``,
     and the falling loss; (d) each mode's bf16 median step, images/s, peak
     and profiled split beside (c)'s float32 ones, and the bf16 kernels'
     time per step at the steps' shapes against the bound at 2-byte
     elements and the bf16 peak; (f) data-parallel training: a wct_se
     ``Trainer`` on ``make_mesh(data=4, devices=["cuda:0"] * 4)`` (four
     replicas of 4 images on the one card) against a single-device one at
     stage 5 x 16 x 256^2, seeded weights, float32 and bf16, six steps
     each: over three steps from the same masters and Adam state the
     losses (1e-5 relative; bf16 BF16_LOSS_REL) and the root's mean
     gradient (1e-4 of each leaf's max|g|; bf16 BF16_STEP_REL in relative
     L2), every replica's masters bit-identical to the root's, launches 4 x
     the single step's (counters zeroed around each step); the median step,
     host enqueue, images/s and peak of both;
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
     ``gram_matrix`` and ``adain`` card vs CPU; (e) the model-asset tools on
     (c)'s store, at full widths: its e5 and d5 as the reference's
     legacy-format ``.pth`` files, ``cli.convert`` back to the store bit for
     bit; ``cli.prune`` of the encoders and decoders of stages 1-5 into
     ``16x_base/`` (the 16x specs' shapes, each call timed); ``cli.train
     --pretrained_init`` wct_se and then wct_sd on the trained encoder, six
     steps each at stage 5 x 16 x 256^2 on 8c's PNGs (launches per step the
     specs', finite losses that fall on the first batch, median step and
     images/s); the wct_se trainer's state through ``save_checkpoint_dcp``
     and ``save_checkpoint``, one step resumed from each bit-equal;
     ``cli.export`` of the trained pair and ``WCTEngine(stages=(5,))`` on the
     512^2 pair (the plain path's launch counts); ``cli.imgtools
     crop-center`` and ``resize`` on the card over 2048^2 PNGs and nvJPEG
     JPEGs, timed.
  10. bfloat16 inference, run after phase 5d and before phase 9: (a) each
     bf16 kernel (``conv3x3_reflect_bf16``, ``conv1x1_bias_bf16``,
     ``max_pool_2x2_bf16``, ``upsample_nearest_2x_bf16``) against its plain
     version at every shape of the bf16 2048^2 plain and UHD slab paths and
     at edge shapes, within one bf16 ulp (pool and upsample exact), timed
     beside the plain version, the library call (cuDNN's bf16 reflect conv,
     and for the conv also cuDNN's bf16 conv alone on a map padded and made
     channels-last outside the timed call, ``library_conv_ms``;
     ``torch.addmm``, ``F.max_pool2d``, ``F.interpolate``) and the bound at
     the bf16 peak; (b) ``WCTEngine(dtype=torch.bfloat16)`` at 2048^2 and
     on the UHD slab path with every count zeroed before and read after
     (the float32 plan's launches on the bf16 kernels, ``sum_gram`` on the
     float32 copy; the bf16 conv's launches by template), the warm cascades (medians of 5 and 3), peaks and
     profiles beside phase 5's and 5b's float32 medians; (c) the bf16
     output against the float32 one on the card (2048^2 above 12 dB, UHD
     printed beside JAX's 15.7 dB) and encoder e5 at 2048^2 card vs CPU in
     bf16; (d) ``cli.stylize --bf16`` on one 2048^2 pair writes the bf16
     engine's pixels; (e) ``conv3x3_reflect_bf16`` with halo rows against
     its plain version within one bf16 ulp at every shape of the bf16
     per-conv path at 2000 x 2048 (shards of unequal heights), timed against
     the same convs reflecting their own rows and ``torch.cat`` of the
     extended shards, and at edge shapes (``BF16_HALO_EDGE``: one row,
     ragged tiles of every bf16 template, N = 2, rows off 16-byte alignment,
     Cin 3, the ``wgmma`` widths); the bf16 conv on photo-WCT's unpooled
     2048^2 decoder maps; ``halo_exchange_rows`` and ``halo_fill_rows`` on
     bf16 shards exactly at every launch of the sharded UHD path, timed as
     in 5c; (f) the bf16 engines with every count zeroed before and read after (the per-conv
     plan ``per_conv_path_calls``, ``sharded_path_calls`` and
     ``pwct_path_calls`` on the bf16 kernels, ``bf16_totals``): per-conv
     (``space=4`` on ``cuda:0``) at 2048^2 and 2000 x 2048 against the bf16
     plain cascade, slab-in-shard UHD (``slab_rows=512``) against the bf16
     slab cascade (both ``packed=False`` there: the two then differ by the
     order of sums alone), photo-WCT 2048^2 against float32 photo-WCT, and 512^2
     bf16 photo-WCT card vs CPU with the card's pool indices; each warm
     (median, peak, profile) beside the float32 median of this run; (g)
     ``cli.stylize --bf16 --space 4 --slab_rows 512 --devices
     cuda:0,cuda:0,cuda:0,cuda:0`` on one 2048^2 pair writes the bf16
     sharded engine's pixels (``packed=False``: the CLI folds only under
     ``--packed``, as the reference's CLI).

With ``--cross-card`` (two or more cards) it runs only the halo checks, the
conv3x3 halo staging with its rows on other cards (float32 and bf16), the
per-conv 2048^2 cascade with one shard per card against the plain one and
timed (float32 and bf16), and the sharded UHD path with neighbouring shards
on different cards, against the single-card slab cascade; then phase 8f's
data-parallel check with one replica a card at 2 cards and at 4 where
present (float32 and bf16), and as many processes, one card each, joined
by ``initialize_multihost`` over NCCL (this script with ``--dp-worker``),
against the single-device step and timed: images/s at 1, 2 and 4 cards;
and ``cli.train`` launched one process a card as ``torchrun`` launches it. It
prints no kernel table. ``--cross-card --dp`` runs the data-parallel part
alone.

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
PEAK_BF16_FLOPS = 0.0   # the tensor cores' dense bf16 peak, the bf16 kernels' bound
PEAK_BYTES = 3.35e12
REPO_PATH = "collaborative_distillation_tpu_torch/ops/cuda/csrc/"
KERNEL_META = {
    "conv3x3_reflect": ("conv3x3.cu", "collaborative_distillation_tpu/ops/pallas/conv.py:754"),
    "conv1x1_bias": ("conv1x1.cu", "collaborative_distillation_tpu/ops/pallas/conv.py:437"),
    "sum_gram": ("sum_gram.cu", "collaborative_distillation_tpu/ops/pallas/stats.py:61"),
    "max_pool_2x2": ("pool.cu", "collaborative_distillation_tpu/ops/pallas/pool.py:96"),
    "upsample_nearest_2x": ("pool.cu", "collaborative_distillation_tpu/ops/pallas/pool.py:141"),
    "halo_exchange_rows": ("halo.cu", "collaborative_distillation_tpu/ops/pallas/halo.py:148"),
    "halo_fill_rows": ("halo.cu", "collaborative_distillation_tpu/ops/pallas/halo.py:148"),
    "conv3x3_reflect_bf16": ("conv3x3_bf16.cu",
                             "collaborative_distillation_tpu/ops/pallas/conv.py:754"),
    "conv1x1_bias_bf16": ("conv1x1.cu", "collaborative_distillation_tpu/ops/pallas/conv.py:437"),
    "max_pool_2x2_bf16": ("pool.cu", "collaborative_distillation_tpu/ops/pallas/pool.py:96"),
    "upsample_nearest_2x_bf16": ("pool.cu",
                                 "collaborative_distillation_tpu/ops/pallas/pool.py:141"),
}
# the bf16 engine's kernel for each float32 one (sum_gram runs on a float32
# copy of the features, as the reference upcasts before its kernel)
BF16_OF = {"conv3x3_reflect": "conv3x3_reflect_bf16", "conv1x1_bias": "conv1x1_bias_bf16",
           "max_pool_2x2": "max_pool_2x2_bf16", "upsample_nearest_2x": "upsample_nearest_2x_bf16"}
# the kernels that only the slab-in-shard path launches
SHARDED_ONLY = ("halo_exchange_rows", "halo_fill_rows")
KERNEL_PATH = {"conv1x1_bias": "UHD slab", **{k: "UHD sharded" for k in SHARDED_ONLY}}
# conv3x3_reflect with halo rows (the per-conv sharded path): its own rows in
# the checks, the kernel's in the table; the same in bf16, and the halo
# exchange and fill on bf16 shards (phase 10e)
KERNEL_OF = {"conv3x3_halo": "conv3x3_reflect", "conv3x3_halo_bf16": "conv3x3_reflect_bf16",
             **{k + "_bf16": k for k in SHARDED_ONLY}}
# the float32 check of each check that Bench runs on bf16 inputs
F32_OF = {**{b: f for f, b in BF16_OF.items()}, "conv3x3_halo_bf16": "conv3x3_halo",
          **{k + "_bf16": k for k in SHARDED_ONLY}}
CONV3X3_NAMES = "conv3x3_kernel"   # the profiler's names of csrc/conv3x3.cu's kernels
# the profiler's names of csrc/halo.cu's kernels (and of the grid-stride
# kernel it held before the segment tables, so that bench_cascade.py reads
# an older checkout's halo time too)
HALO_NAMES = ("segment_copy_kernel", "halo_rows_kernel")
# the profiler's names of the bf16 ring kernel's conv3x3 and 1x1 instantiations
# (bf16_igemm.cuh's ``bf16_ring_kernel<Ring<TAPS, ...>>``)
BF16_RING_KERNEL = "bf16_ring_kernel"
BF16_CONV_NAMES = {"conv3x3_reflect_bf16": "Ring<9,", "conv1x1_bias_bf16": "Ring<1,"}
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
#   pool, upsample, halo_exchange_rows, halo_fill_rows: exact (a max and
#     copies).
#   a whole encoder or decoder, card vs CPU on the same inputs (phases 2
#     and 9a): 1e-4 of the output's largest magnitude (CONV_TOL compounded
#     over up to 16 convs, pools and unpools; 7.6e-6 read at 16x16).
#   phase 8a, a conv3x3 with a ReLU: the kernel's and the plain version's
#     pre-activations may take opposite sides of 0 where they lie within
#     rounding of it, at most RELU_FLIP_SHARE of a shape's outputs (and 2).
#   bf16 conv3x3 and conv1x1 (phase 10): one bf16 ulp elementwise, |kernel -
#     plain| <= 2^-7 |plain| with a floor of 1e-3 max|plain| (both round f32
#     sums of exact products once; a sum near a rounding boundary may round
#     the other way); bf16 pool and upsample exact. A bf16 encoder, card vs
#     CPU: BF16_STAGE_TOL of the output's largest magnitude (the reference's
#     bf16 kernel against its XLA path, tests/test_pallas_conv.py:303).
#   bf16 training (phase 8e): a Function's bf16 gradients against the plain
#     version's autograd (float32 sums of exact products, one rounding),
#     under the Function's ReLU decisions: dw and db within one bf16 ulp
#     (2^-7 |ref|) plus CONV_TOL of the largest partial sum (float32 sums
#     in another order; a bf16 accumulation over the 1M pixels of a wgrad
#     would miss it by orders of magnitude); dx within one ulp of itself
#     and of its elementwise partial sum (the pad's gradient folds onto the
#     border in bf16 after the data gradient rounds). One bf16 step card vs
#     CPU: losses within BF16_LOSS_REL (2^-6), each student leaf's gradient
#     within BF16_STEP_REL (2^-4) in relative L2 norm: the two round in
#     other orders, so they differ by about one bf16 step's own error,
#     which tests/test_torch_train_bf16.py holds to twice that of rounding
#     the step's inputs to bf16 (against float64).
#   bf16 cascade vs float32 on the card: BF16_PSNR_MIN_DB (the reference's
#     bf16 floor, tests/test_engine.py:44; its UHD photo reading, 15.7 dB,
#     BENCH_r05.json uhd_bf16_photo_psnr_db, is JAX_BF16_PHOTO_DB); two bf16
#     cascades that differ by the order of float32 sums alone: a sharded one
#     against its single-card one, on one card or across cards,
#     BF16_SHARD_MIN_DB (42.3-43.3 dB read: an order 104-107 dB apart in
#     float32 moves a bf16 rounding of M and so the later stages; a kernel
#     that ignored the halo rows read 35.96 dB at per-conv 2048^2, so the
#     floor sits between), bf16 photo-WCT card vs CPU with shared pool
#     indices BF16_ORDER_MIN_DB (38.8 dB read); bf16
#     photo-WCT against float32 photo-WCT BF16_PWCT_MIN_DB (bf16
#     ties move the unpool's maxima: 12.5 dB read at 512^2 on the card, and
#     the reference's own bf16 photo-WCT reads 12.1 dB from its float32 on
#     the CPU at 256^2). That floor only refuses an output unlike any
#     stylization of the pair; it checks no bf16 arithmetic. bf16 photo-WCT
#     is held by the 512^2 card-vs-CPU comparison with shared pool indices
#     (each stage within BF16_STAGE_TOL, the cascade BF16_ORDER_MIN_DB).
#   conv0 folded into conv1_1 (phase 5e) against packed=False: float32
#     PSNR_MIN_DB (the fold is exact arithmetic; 105.25 dB read at UHD). In
#     bf16 the folded weights (255x, a permutation) and bias round to bf16
#     once, as in the reference, and the two bf16 cascades read 38.23 dB
#     apart at UHD, so each is held to float32 instead: the folded one no
#     more than BF16_FOLD_COST_DB farther from the float32 folded output than
#     the unfolded one, the reference's own cost of its fold (its bf16 slab
#     path 49.44 dB from float32 unfolded, 44.71 folded, on
#     tests/test_torch_bf16.py's 704 x 64 crop on the CPU:
#     tools/fold_accuracy.py).
CONV_TOL = 1e-5
BF16_ULP = 2.0 ** -7
BF16_FLOOR = 1e-3
BF16_STAGE_TOL = 2e-2
BF16_LOSS_REL = 2.0 ** -6
BF16_STEP_REL = 2.0 ** -4
BF16_PSNR_MIN_DB = 12.0
JAX_BF16_PHOTO_DB = 15.7
BF16_PWCT_MIN_DB = 9.0
BF16_ORDER_MIN_DB = 30.0
BF16_SHARD_MIN_DB = 39.0
BF16_FOLD_COST_DB = 4.73
STAGE_TOL = 1e-4
RELU_FLIP_SHARE = 1e-5
GRAM_TOL = 2e-5
COV64_TOL = 1e-4
PSNR_MIN_DB = 40.0
CACHE_TOL = 1e-6
# nvJPEG against libjpeg's decodes in data/jpeg_fixture.npz (phase 6a): the
# file's own 4:2:0 planes within NVJPEG_PLANE_MAX levels and a mean of
# NVJPEG_PLANE_MEAN (only the IDCTs' rounding differs; read 1 and 0.016);
# RGB and an nvJPEG q95 round trip at PSNR_MIN_DB (nvJPEG's chroma upsampling
# is not libjpeg's fancy one). A JPEG request (phases 7a, 7b) against the
# uint8 cascade output: JPEG_PSNR_MIN_DB, its content and its response each
# once through q95 (38.9 dB with libjpeg on the CPU at 512^2).
NVJPEG_PLANE_MAX = 1
NVJPEG_PLANE_MEAN = 0.05
JPEG_PSNR_MIN_DB = 35.0
JPEG_FIXTURE_FILES = ("in1", "c444", "prog", "odd", "grey")
JPEG_REQUESTS = 10           # phase 7a: JPEG requests at 2048^2, one at a time
UHD_H, UHD_W = 4096, 10240   # the README's 10240x4096 UHD image, rows first
UHD_SLAB = 1024
SHARDS = 4                   # row shards of the sharded UHD path
SHARD_SLAB = 512             # two slabs in each 1024-row shard
AWK_H = 4000                 # phase 4d: no multiple of either slab size
PC_AWK_H = 2000              # phases 2, 4c: a multiple of 16, not of 16 * SHARDS
ORIGINAL_HW = 1024           # phase 7f: the warm mode-original cascade's size
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


def sharded_path_calls(pyramid, stages, margins, slab, space, h, w, sh, sw, devices=None):
    """Kernel calls of one sharded slab cascade (no style key) on an (h, w)
    content cut into ``space`` row shards of a multiple of ``slab`` rows,
    and an (sh, sw) style: per stage the style's encode and statistics on
    the engine's device; the halos (2 * margin rows from each neighbour),
    at the first stage one ``halo_exchange_rows`` launch a card that
    extends its shards whole, at every later one a ``halo_fill_rows``
    launch a card that fills only the halo rows of the extended shards the
    stage before decoded into; then per shard pass 1 over its slabs of
    ``slab + 2 * margin`` rows and pass 2, which encodes each slab again.
    ``devices``: the shards' devices (default: all on one card). The halos'
    shapes are (1, h_loc, w, 3, hm, shards on the card, 0)."""
    calls, layer_of = Counter(), {}
    h_loc = h // space
    n_slabs = h_loc // slab
    per_card = Counter(devices or ["cuda:0"] * space)
    for i, k in enumerate(stages):
        es, ds = pyramid[k]["enc_spec"], pyramid[k]["dec_spec"]
        c, down = es.out_channels, 2 ** (k - 1)
        hh, ww = _encoder_calls(calls, layer_of, k, es, sh, sw)
        calls[("sum_gram", (hh * ww, c))] += 1
        hm = 2 * margins[k]
        rows = slab + hm
        for n_shards in per_card.values():
            calls[("halo_fill_rows" if i else "halo_exchange_rows",
                   (1, h_loc, w, 3, hm, n_shards, 0))] += 1
        for d in range(space):
            for _ in range(n_slabs):
                fh, fw = _encoder_calls(calls, layer_of, k, es, rows, w)
                calls[("sum_gram", (slab // down * fw, c))] += 1
            for _ in range(n_slabs):
                _encoder_calls(calls, layer_of, k, es, rows, w)
                calls[("conv1x1_bias", (1, fh, fw, c, c, False, True, 0))] += 1
                assert _decoder_calls(calls, layer_of, k, ds, fh, fw) == (rows, w)
    return calls, layer_of


def per_conv_calls(pyramid, stages, rows, w):
    """Halo convs of one per-conv sharded cascade (``space`` without
    ``slab_rows``) on a content cut into shards of ``rows`` rows, ``w``
    wide: every conv of the content's encoder and of the decoder, once per
    shard, each a ``conv3x3_reflect`` launch that stages its neighbours'
    boundary rows (the style's statistics are taken whole, with plain
    convs). Keyed ``("conv3x3_halo", (1, h, w, Cin, Cout, relu, sides, 0))``:
    ``sides`` the rows given, "both" or, at a global edge of a shard of two
    or more rows, "bot" (first shard) or "top" (last shard)."""
    calls = Counter()
    last = len(rows) - 1
    for k in stages:
        down = 2 ** (k - 1)
        for spec, scale in ((pyramid[k]["enc_spec"], 1), (pyramid[k]["dec_spec"], down)):
            f = scale
            for l in spec.layers:
                for d, h in enumerate(rows):
                    hh = h // f
                    sides = ("bot" if d == 0 and hh > 1 else "top" if d == last and hh > 1
                             else "both")
                    calls[("conv3x3_halo", (1, hh, w // f, l.in_ch, l.out_ch, l.relu,
                                            sides, 0))] += 1
                if l.pool_after:
                    f *= 2
                if l.unpool_after:
                    f //= 2
    return calls


def per_conv_path_calls(pyramid, stages, rows, w, sh, sw) -> Counter:
    """Kernel calls of one whole per-conv sharded cascade (no style key) on a
    content cut into shards of ``rows`` rows, ``w`` wide, and an (sh, sw)
    style: per stage the style's encode and statistics whole on the engine's
    device; per shard the content's halo convs (:func:`per_conv_calls`), its
    pools, one ``sum_gram`` (the shard's sums), one ``conv1x1_bias`` (the
    folded WCT), the decoder's halo convs and upsamples."""
    calls = per_conv_calls(pyramid, stages, rows, w)
    for k in stages:
        es, ds = pyramid[k]["enc_spec"], pyramid[k]["dec_spec"]
        c, down = es.out_channels, 2 ** (k - 1)
        hh, ww = _encoder_calls(calls, {}, k, es, sh, sw)
        calls[("sum_gram", (hh * ww, c))] += 1
        for h in rows:
            f = 1
            for l in es.layers:
                if l.pool_after:
                    calls[("max_pool_2x2", (1, h // f, w // f, l.out_ch))] += 1
                    f *= 2
            calls[("sum_gram", (h // down * (w // down), c))] += 1
            calls[("conv1x1_bias", (1, h // down, w // down, c, c, False, True, 0))] += 1
            for l in ds.layers:
                if l.unpool_after:
                    calls[("upsample_nearest_2x", (1, h // f, w // f, l.out_ch))] += 1
                    f //= 2
    return calls


def bf16_totals(kc, calls) -> dict:
    """{kernel name: launches} of a float32 plan's {(kernel, shape): count}
    on the bf16 engine, for every float32 and bf16 kernel: the plan's
    kernels on their bf16 entries (``BF16_OF``; a halo conv is a
    ``conv3x3_reflect_bf16`` launch), ``sum_gram`` on float32 copies and
    ``halo_exchange_rows`` (byte-generic) under their own names."""
    out = {k.__name__: 0 for k in kc.KERNELS + kc.BF16_KERNELS}
    for (kernel, _), n in calls.items():
        out[BF16_OF.get(KERNEL_OF.get(kernel, kernel), kernel)] += n
    return out


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


def work(kernel, shape, itemsize=4):
    """(bytes, flops) the function must move and compute: each input read
    once, each output written once, ``itemsize`` bytes an element (4 in
    float32, 2 in bf16; a bf16 1x1's bias is float32)."""
    e = itemsize
    if kernel == "conv3x3_reflect":
        n, h, w, ci, co = shape[:5]
        px = n * h * w
        return e * (px * ci + 9 * ci * co + co + px * co), 2 * 9 * ci * co * px
    if kernel == "conv1x1_bias":
        n, h, w, ci, co, _, bias, _ = shape
        px = n * h * w
        return e * (px * ci + ci * co + px * co) + (4 * co if bias else 0), 2 * ci * co * px
    if kernel == "sum_gram":
        # X^T X is symmetric: c(c+1)/2 distinct entries, a multiply and an add
        # each per row; the column sum and the shift subtraction p*c each
        p, c = shape[:2]
        return 4 * (p * c + c + c * c + c), p * c * (c + 1) + 2 * p * c
    if kernel == "conv3x3_halo":
        # what the halo staging adds to the conv: the neighbours' boundary
        # rows, read once (a null side reads nothing new)
        n, h, w, ci, _, _, sides = shape[:7]
        return e * n * w * ci * (2 if sides == "both" else 1), 0
    if kernel in SHARDED_ONLY:
        # (N, H, W, C, hm, position or shards, offset): every row written
        # once (the fill writes only the halos), each row with a source read
        # once (a global edge's zero fill reads nothing); k shards of one
        # launch have 2 (k - 1) sourced halos
        n, h, w, c, hm, pos, _ = shape
        k, sources = ((1, (pos != "first") + (pos != "last")) if isinstance(pos, str)
                      else (pos, 2 * (pos - 1)))
        inner = 2 * h if kernel == "halo_exchange_rows" else 0
        return e * n * w * c * (k * (inner + 2 * hm) + sources * hm), 0
    n, h, w, c = shape
    if kernel == "max_pool_2x2":
        out = n * (h // 2) * (w // 2) * c
        return e * (n * h * w * c + out), 3 * out
    return e * (n * h * w * c * 5), 0


def device_ms(torch, fn, reps):
    """Milliseconds of device time per call: the profiler's CUDA kernel time
    over ``reps`` calls after one warm-up, divided by ``reps``. Unlike
    :func:`cuda_ms`, what the card spends whatever the host's pace: short
    kernels queued by a slower host leave gaps that events would count."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")) / 1e3 / reps


L2_FLUSH_BYTES = 256 << 20   # over four times the H100's 50 MB L2


def queued_ms(torch, fn, reps, flush=True):
    """Milliseconds of device time per call, the host's pace taken out and
    no profiler: a sleep kernel holds the stream while ``reps`` calls, each
    between two events, are queued, so the card runs them back to back. With
    ``flush`` a read of ``L2_FLUSH_BYTES`` before each call evicts the last
    call's rows from L2 (outside the events), so each call reads and writes
    HBM: back to back on the same buffers, a copy of under 50 MB is served
    from L2 and reads faster than its HBM bound. The sleep lasts some four
    times the enqueue time of the calls, measured just before (cycles at
    ~2 GHz)."""
    junk = (torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if flush else None)
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]

    def queue():
        for a, b in pairs:
            if flush:
                junk.amax()
            a.record()
            fn()
            b.record()

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    queue()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(8e9 * enqueue_s) + 1_000_000)
    queue()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


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
            if KERNEL_OF.get(kernel, kernel) in SHARDED_ONLY:
                return self._run_halo(kernel, shape, timed, reps)
            if kernel in F32_OF:
                return self._run_bf16(kernel, shape, layer, timed, reps)
            return self._run(kernel, shape, layer, timed, reps)

    def _run_bf16(self, kernel, shape, layer, timed, reps):
        """A bf16 kernel at a float32 plan's shape: bf16 inputs (a layer's
        params rounded to bf16), one-ulp agreement with the plain version
        (pool and upsample exact), times against cuDNN's bf16 reflect conv,
        ``torch.addmm`` in bf16, ``F.max_pool2d``, ``F.interpolate``. The
        halo conv on bf16 maps as ``_run`` takes it in float32, within one
        ulp."""
        torch, F = self.torch, self.F
        from collaborative_distillation_tpu_torch.ops import cuda as kc
        bf = torch.bfloat16
        k = getattr(kc, KERNEL_OF.get(kernel, kernel))
        row = {"kernel": kernel, "shape": list(shape)}
        own, kw = None, {}
        if kernel == "conv3x3_halo_bf16":
            # (N, H, W, Cin, Cout, relu, sides, offset[, row offset, row
            # pad]): x and two neighbour maps of other heights ``offset``
            # elements into their buffers (the neighbours ``row offset``
            # where given, with ``row pad`` elements after each image: a
            # batch stride of the rows off 16 bytes), the rows views of
            # them; timed as the float32 halo conv
            n, h, w, ci, co, relu, sides, offset, *rows_at = shape
            row_offset, row_pad = rows_at or (offset, 0)

            def map_(rows, at=offset, pad=0):
                per = rows * w * ci
                buf = (self.rand(n * (per + pad) + at) - 0.5).to(bf)[at:].view(n, per + pad)
                return buf[:, :per].view(n, rows, w, ci)
            x = map_(h)
            up, down = map_(h + 1, row_offset, row_pad), map_(max(h - 1, 1), row_offset, row_pad)
            top = up[:, -1:] if sides in ("both", "top") else None
            bot = down[:, :1] if sides in ("both", "bot") else None
            wt = ((self.rand(3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)).to(bf)
            b = (self.rand(co) - 0.5).to(bf)
            args = (x, wt, b, relu)
            kw = {"top": top, "bot": bot}
            parts = [x[:, 1:2] if top is None else top, x, x[:, -2:-1] if bot is None else bot]
            library = lambda: torch.cat(parts, dim=1)
            own = lambda: k(x, wt, b, relu)
        elif kernel == "conv3x3_reflect_bf16":
            n, h, w, ci, co, relu, *rest = shape
            offset = rest[0] if rest else 0
            x = self.rand(n * h * w * ci + offset).to(bf)[offset:].view(n, h, w, ci)
            if layer is not None:
                stage, part, name = layer
                p = self.pyramid[stage][part][name]
                wt, b = p["w"].to(bf).contiguous(), p["b"].to(bf).contiguous()
            else:
                wt = ((self.rand(3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)).to(bf)
                b = (self.rand(co) - 0.5).to(bf)
            args = (x, wt, b, relu)
            if timed:
                lib = torch.nn.Conv2d(ci, co, 3, padding=1, padding_mode="reflect",
                                      device="cuda", dtype=bf)
                lib.weight.copy_(wt.permute(3, 2, 0, 1))
                lib.bias.copy_(b)
                xn = x.permute(0, 3, 1, 2)   # NHWC memory as a channels-last NCHW view
                library = lambda: lib(xn)
                # cuDNN's bf16 conv alone: the reflect pad and the
                # channels-last layout made outside the timed call
                xp = F.pad(xn, (1, 1, 1, 1), mode="reflect").contiguous(
                    memory_format=torch.channels_last)
                wn = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                library_conv = lambda: F.conv2d(xp, wn, b)
        elif kernel == "conv1x1_bias_bf16":
            n, h, w, ci, co, relu, bias, offset = shape
            x = (self.rand(n * h * w * ci + offset) - 0.5).to(bf)[offset:].view(n, h, w, ci)
            wt = ((self.rand(ci, co) - 0.5) * (2 / ci ** 0.5)).to(bf)
            b = self.rand(co) - 0.5 if bias else None
            args = (x, wt, b, relu)
            x2, b16 = x.view(-1, ci), None if b is None else b.to(bf)
            library = ((lambda: torch.addmm(b16, x2, wt)) if bias else (lambda: torch.mm(x2, wt)))
        else:
            n, h, w, c = shape
            x = self.rand(n, h, w, c).to(bf)
            args = (x,)
            xn = x.permute(0, 3, 1, 2)
            library = ((lambda: F.max_pool2d(xn, 2)) if kernel == "max_pool_2x2_bf16"
                       else (lambda: F.interpolate(xn, scale_factor=2, mode="nearest")))
        got, ref = k(*args, **kw), k.plain(*args, **kw)
        torch.cuda.synchronize()
        if got.shape != ref.shape or got.dtype != bf:
            raise AssertionError(f"{kernel}{shape}: {tuple(got.shape)} {got.dtype} != "
                                 f"{tuple(ref.shape)} bfloat16")
        g, r = got.float(), ref.float()
        err = float((g - r).abs().max()) if ref.numel() else 0.0
        scale = float(r.abs().max()) if ref.numel() else 1.0
        if kernel.startswith("conv"):
            bound = torch.clamp(r.abs() * BF16_ULP, min=BF16_FLOOR * scale)
            misses = int(((g - r).abs() > bound).sum())
        else:
            misses = int((g != r).sum())
        del got, ref, g, r
        row.update(max_abs_err=err, max_rel_err=err / max(scale, 1e-30), ulp_misses=misses,
                   ok=misses == 0)
        if misses:
            raise AssertionError(f"{kernel}{shape}: {misses} outputs more than one bf16 ulp "
                                 f"from the plain version (max abs err {err})")
        if timed:
            nbytes, flops = work(F32_OF[kernel], shape, 2)
            row.update(ms=cuda_ms(torch, lambda: k(*args, **kw), reps),
                       plain_ms=cuda_ms(torch, lambda: k.plain(*args, **kw), reps),
                       library_ms=cuda_ms(torch, library, reps),
                       bytes_ms=nbytes / PEAK_BYTES * 1e3, flops_ms=flops / PEAK_BF16_FLOPS * 1e3)
            if kernel == "conv3x3_reflect_bf16":
                row["library_conv_ms"] = cuda_ms(torch, library_conv, reps)
            if own is not None:
                # what the rows add to the conv, on the device (the profiler:
                # a bf16 shard-conv at the deep levels is shorter than its
                # wrapper's host time, which events would count) and by events
                row.update(conv_ms=device_ms(torch, lambda: k(*args, **kw), reps),
                           reflect_ms=device_ms(torch, own, reps),
                           event_conv_ms=row["ms"], event_reflect_ms=cuda_ms(torch, own, reps),
                           library_device_ms=device_ms(torch, library, reps))
                row["ms"] = row["conv_ms"] - row["reflect_ms"]
                row["event_ms"] = row["event_conv_ms"] - row["event_reflect_ms"]
        return row

    def _run(self, kernel, shape, layer, timed, reps):
        torch, F = self.torch, self.F
        from collaborative_distillation_tpu_torch.ops import cuda as kc
        k = getattr(kc, KERNEL_OF.get(kernel, kernel))
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
        elif kernel == "conv3x3_halo":
            # conv3x3_reflect with halo rows: (N, H, W, Cin, Cout, relu, sides,
            # float offset); x and two neighbour maps of other heights start
            # ``offset`` floats into their buffers, the rows are views of
            # them (the upper map's last row, the lower one's first). Timed:
            # ``ms`` is what the rows add, the halo conv's time less that of
            # the same conv reflecting its own rows; ``library_ms`` is
            # torch.cat of the extended shard, the exchange that the rows
            # replace
            n, h, w, ci, co, relu, sides, offset = shape

            def map_(rows):
                return self.rand(n * rows * w * ci + offset)[offset:].view(n, rows, w, ci)
            x, up, down = map_(h), map_(h + 1), map_(max(h - 1, 1))
            top = up[:, -1:] if sides in ("both", "top") else None
            bot = down[:, :1] if sides in ("both", "bot") else None
            wt = (self.rand(3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)
            b = self.rand(co) - 0.5
            got = k(x, wt, b, relu, top=top, bot=bot)
            ref = k.plain(x, wt, b, relu, top=top, bot=bot)
            # the rows' magnitudes are x's (all three are rand)
            scale = float(x.abs().max() * wt.abs().sum(dim=(0, 1, 2)).max() + b.abs().max())
            err = float((got - ref).abs().max())
            tol = CONV_TOL * scale
            del got, ref
            call = lambda: k(x, wt, b, relu, top=top, bot=bot)
            plain = lambda: k.plain(x, wt, b, relu, top=top, bot=bot)
            parts = [x[:, 1:2] if top is None else top, x, x[:, -2:-1] if bot is None else bot]
            library = lambda: torch.cat(parts, dim=1)
            own = lambda: k(x, wt, b, relu)
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
            if kernel == "conv3x3_halo":   # what the rows add to the conv
                row.update(conv_ms=row["ms"], reflect_ms=cuda_ms(torch, own, reps))
                row["ms"] = row["conv_ms"] - row["reflect_ms"]
        return row

    def _run_halo(self, kernel, shape, timed, reps):
        """``halo_exchange_rows`` or ``halo_fill_rows`` (``_bf16``: on bf16
        maps) at (N, H, W, C, hm, position or shards, offset). A position
        ("first", "mid", "last") is one exchange of one shard; an int k is
        one launch for k neighbouring shards of one card, as the
        slab-in-shard path makes it: the exchange extends k shards, the fill
        writes the halo rows of k extended shards from their neighbours'
        interiors. Every map starts ``offset`` elements into its buffer.
        Exactly the plain version (the fill's halos hold NaN before it).
        Timed on the device (:func:`queued_ms`, L2 evicted before each call:
        a fill is shorter than its wrapper's host time, which events count)
        and by events (``*event_ms``, the host's pace included): ``ms`` the
        kernel (``l2_warm_ms`` back to back on the same buffers, L2 kept);
        ``library_ms`` torch.cat of the extended shards (the exchange at
        every stage that the fill replaces); ``copy_ms`` the same row blocks
        by one ``copy_`` or ``zero_`` each into ready maps (for the fill its
        plain version); ``plain_ms`` by events."""
        torch = self.torch
        from collaborative_distillation_tpu_torch.ops import cuda as kc
        from collaborative_distillation_tpu_torch.ops.cuda import halo as khalo
        base = KERNEL_OF.get(kernel, kernel)
        dtype = torch.bfloat16 if kernel.endswith("_bf16") else torch.float32
        n, h, w, c, hm, pos, offset = shape

        def rows(r):
            return self.rand(n * r * w * c + offset).to(dtype)[offset:].view(n, r, w, c)

        fill = base == "halo_fill_rows"
        k = 1 if isinstance(pos, str) else pos
        maps = [rows(h + 2 * hm if fill else h) for _ in range(k)]
        interiors = [m[:, hm:hm + h] for m in maps] if fill else maps
        if isinstance(pos, str):
            up, down = rows(h), rows(h)
            items = [(maps[0], up[:, -hm:] if pos != "first" else None,
                      down[:, :hm] if pos != "last" else None)]
        else:
            items = [(maps[d], interiors[d - 1][:, -hm:] if d else None,
                      interiors[d + 1][:, :hm] if d < k - 1 else None) for d in range(k)]
        zeros = torch.zeros((n, hm, w, c), device="cuda", dtype=dtype)
        parts = [[zeros if t is None else t, x, zeros if b is None else b]
                 for x, (_, t, b) in zip(interiors, items)]
        if fill:
            want = [m.clone() for m in maps]
            khalo.halo_fill_rows_plain([(m, *it[1:]) for m, it in zip(want, items)], hm)
            for m in maps:
                m[:, :hm] = float("nan")
                m[:, hm + h:] = float("nan")
            call = lambda: kc.halo_fill_rows(items, hm)
            plain = lambda: khalo.halo_fill_rows_plain(items, hm)
            copy = plain
            call()
            got = maps
        else:
            want = [khalo.halo_exchange_rows_plain(*it, hm) for it in items]
            call = lambda: kc.halo_exchange_rows_many(items, hm)
            plain = lambda: [khalo.halo_exchange_rows_plain(*it, hm) for it in items]
            outs = [torch.empty_like(x) for x in want]

            def copy():
                for out, (x, t, b) in zip(outs, items):
                    for dst, src in ((out[:, :hm], t), (out[:, hm:hm + h], x),
                                     (out[:, hm + h:], b)):
                        dst.zero_() if src is None else dst.copy_(src)
            got = call()
        torch.cuda.synchronize()
        if not all(g.shape == r.shape and torch.equal(g, r) for g, r in zip(got, want)):
            raise AssertionError(f"{kernel}{shape}: the kernel differs from its plain version")
        del got, want
        row = {"kernel": kernel, "shape": list(shape), "max_abs_err": 0.0, "max_rel_err": 0.0,
               "tol": 0.0, "ulp_misses": 0, "ok": True}
        if timed:
            nbytes, _ = work(base, shape, 2 if dtype == torch.bfloat16 else 4)
            cat = lambda: [torch.cat(p, dim=1) for p in parts]
            row.update(ms=queued_ms(torch, call, reps),
                       l2_warm_ms=queued_ms(torch, call, reps, flush=False),
                       event_ms=cuda_ms(torch, call, reps),
                       plain_ms=cuda_ms(torch, plain, reps),
                       library_ms=queued_ms(torch, cat, reps),
                       library_event_ms=cuda_ms(torch, cat, reps),
                       copy_ms=queued_ms(torch, copy, reps),
                       copy_event_ms=cuda_ms(torch, copy, reps),
                       bytes_ms=nbytes / PEAK_BYTES * 1e3, flops_ms=0.0)
        return row


def halo_per_cascade(rows, label) -> dict:
    """The halos of one slab-in-shard cascade from its timed halo rows
    (each with its ``calls``): the exchange and the fills summed, beside the
    bound and both yardsticks; logged."""
    t = {"launches": sum(r["calls"] for r in rows), **path_times(rows),
         **{k: path_times([r for r in rows if r["kernel"].startswith(k)])["ms"]
            for k in SHARDED_ONLY}}
    log(f"{label} slab-in-shard halos per UHD cascade: {t['ms']:.4f} ms of device time over "
        f"{t['launches']} launches, L2 evicted before each (exchange "
        f"{t['halo_exchange_rows']:.4f}, fills {t['halo_fill_rows']:.4f}; L2 kept "
        f"{t['l2_warm_ms']:.4f}), bound {t['bound_ms']:.4f} ({t['bound_by']}); torch.cat "
        f"of the extended shards {t['library_ms']:.4f}, copy_/zero_ of the same rows "
        f"{t['copy_ms']:.4f}; by events (host pace included) {t['event_ms']:.4f}, torch.cat "
        f"{t['library_event_ms']:.4f}, copy_/zero_ {t['copy_event_ms']:.4f}, plain "
        f"{t['plain_ms']:.4f}")
    return t


def halo_in_cascade(prof, launches) -> dict:
    """The halos' device time in one profiled slab-in-shard cascade on one
    card, by kernel: the first ``halo.cu`` launch is the exchange, the rest
    the fills (``launches`` of them in all, else not measured: None). In
    the cascade a fill reads rows that the decode has just written, from L2
    where they still lie there."""
    ms = prof.get("halo_launch_ms") or []
    if len(ms) != launches:
        return {k: None for k in SHARDED_ONLY}
    return {"halo_exchange_rows": ms[0], "halo_fill_rows": sum(ms[1:])}


def conv3x3_sha256(torch, kc, calls) -> str:
    """SHA-256 of the conv3x3 kernel's outputs at every conv shape of
    ``calls`` (a path's {(kernel, shape): count}), in sorted order, on inputs
    made from one seed: equal across two checkouts whose kernels compute
    the same bits at those shapes."""
    import hashlib
    gen = torch.Generator(device="cuda").manual_seed(0)
    sha = hashlib.sha256()
    with torch.no_grad():
        for kernel, shape in sorted(calls, key=str):
            if kernel != "conv3x3_reflect":
                continue
            n, h, w, ci, co, relu = shape[:6]
            x = torch.rand((n, h, w, ci), generator=gen, device="cuda")
            wt = (torch.rand((3, 3, ci, co), generator=gen, device="cuda") - 0.5) * 0.1
            b = torch.rand((co,), generator=gen, device="cuda") - 0.5
            sha.update(kc.conv3x3_reflect(x, wt, b, relu).cpu().numpy().tobytes())
    return sha.hexdigest()


def path_times(mine) -> dict:
    """A kernel's timed shapes summed over one cascade, weighted by their
    calls: ms, plain_ms, library_ms and the bound. Each shape is bound by the
    larger of its two times; the sum is labelled by the side that sets most
    of it."""
    tot = lambda key: sum(r[key] * r["calls"] for r in mine)
    by_bytes = sum(r["bytes_ms"] * r["calls"] for r in mine if r["bytes_ms"] >= r["flops_ms"])
    by_ops = sum(r["flops_ms"] * r["calls"] for r in mine if r["bytes_ms"] < r["flops_ms"])
    out = {"ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": by_bytes + by_ops,
           "bound_by": "bytes" if by_bytes >= by_ops else "operations",
           "bound_bytes_ms": by_bytes, "bound_ops_ms": by_ops,
           "library_ms": tot("library_ms")}
    for key in ("library_conv_ms", "copy_ms", "event_ms", "library_event_ms", "copy_event_ms",
                "l2_warm_ms"):
        if mine and all(key in r for r in mine):
            out[key] = tot(key)
    return out


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
    bf16 = Counter()   # the bf16 tile code's conv3x3 and 1x1, by their full names
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            ms = getattr(e, "self_device_time_total", 0.0) / 1e3
            if ms > 0:
                kernels[e.key[:90]] += ms
                calls[e.key[:90]] += e.count
                for name, geom in BF16_CONV_NAMES.items():
                    if BF16_RING_KERNEL in e.key and geom in e.key.replace(" ", ""):
                        bf16[name] += ms
                        bf16[name + "_calls"] += e.count
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
    halo = sum(ms for name, ms in kernels.items() if any(h in name for h in HALO_NAMES))
    halo_calls = sum(n for name, n in calls.items() if any(h in name for h in HALO_NAMES))
    halo_launch_ms = [ms for _, ms in sorted(
        (e.time_range.start, e.time_range.elapsed_us() / 1e3) for e in prof.events()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
        and any(h in e.name for h in HALO_NAMES))]
    log(f"{label}: profiled cascade wall {wall_ms:.2f} ms, event span {span_ms:.2f} ms, "
        f"device busy {busy:.2f} ms, idle share {1 - busy / span_ms:.3f}; sum_gram "
        f"{sg:.3f} ms over {sg_calls} CUDA launches; conv3x3_reflect {c3:.3f} ms over "
        f"{c3_calls}"
        + "".join(f"; {name} {bf16[name]:.3f} ms over {bf16[name + '_calls']}"
                  for name in BF16_CONV_NAMES if bf16[name + "_calls"])
        + (f"; halo.cu {halo:.3f} ms over {halo_calls}" if halo_calls else "")
        + "; top device time:")
    for name, ms in top:
        log(f"    {ms:8.3f} ms  x{calls[name]:<4d} {name}")
    return {"wall_ms": wall_ms, "span_ms": span_ms, "busy_ms": busy,
            "idle_share": 1 - busy / span_ms, "sum_gram_ms": sg, "conv3x3_ms": c3,
            "halo_ms": halo, "halo_calls": halo_calls, "halo_launch_ms": halo_launch_ms,
            "bf16_conv_ms": dict(bf16),
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


def cross_card(torch, kc, WCTEngine, bench, c_uhd, c2k, s2k, calls_sh) -> dict:
    """Phases 2, 3c, 4c and 5c for shards on different cards (two or more
    visible; ``calls_sh`` the sharded plan with the shards spread over them):
    the halo exchange and fill reading neighbours' rows on other cards (peer
    pointers, or the copy where the cards have no peer access) against their
    plain versions, exactly; conv3x3's halo staging reading its rows there
    against its plain version (CONV_TOL); the per-conv 2048^2 cascade with
    one shard per card against the plain one, with its launches, and timed
    (:func:`per_conv_timing`: median of 5, peak per card); the sharded
    UHD path with neighbouring shards on different cards, its launch counts,
    its output against the single-card slab cascade, and its warm time and
    per-card peak memory."""
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
        # the fill of two extended shards on this card, their outer halos
        # from the neighbours' interiors on the other cards
        exts = [bench.rand(n * (h + 2 * hm) * w * c + offset)[offset:].view(n, h + 2 * hm, w, c)
                for _ in range(2)]
        items = [(exts[0], up[:, -hm:], exts[1][:, hm:2 * hm]),
                 (exts[1], exts[0][:, h:h + hm], down[:, :hm])]
        want = [e.clone() for e in exts]
        kc.halo_fill_rows.plain([(m, *it[1:]) for m, it in zip(want, items)], hm)
        kc.halo_fill_rows(items, hm)
        torch.cuda.synchronize()
        if not all(torch.equal(e, r) for e, r in zip(exts, want)):
            raise AssertionError(f"halo_fill_rows{(n, h, w, c, hm, offset)} with neighbours "
                                 f"on other cards differs from its plain version")
    log("cross-card: halo_exchange_rows and halo_fill_rows with neighbours on other cards "
        "equal their plain versions exactly at 3 shapes")
    worst = 0.0
    for n, h, w, ci, co in [(1, 512, 2048, 3, 16), (2, 9, 33, 16, 16), (1, 64, 256, 64, 64),
                            (1, 32, 128, 128, 128), (1, 17, 40, 256, 24), (1, 1, 64, 32, 24)]:
        x = bench.rand(n, h, w, ci) - 0.5
        up = (bench.rand(n, 3, w, ci) - 0.5).to("cuda:1")
        down = (bench.rand(n, 2, w, ci) - 0.5).to(f"cuda:{n_cards - 1}")
        wt = (bench.rand(3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)
        b = bench.rand(co) - 0.5
        got = kc.conv3x3_reflect(x, wt, b, True, top=up[:, -1:], bot=down[:, :1])
        ref = kc.conv3x3_reflect.plain(x, wt, b, True, top=up[:, -1:], bot=down[:, :1])
        torch.cuda.synchronize()
        scale = float(0.5 * wt.abs().sum(dim=(0, 1, 2)).max() + b.abs().max())
        rel = float((got - ref).abs().max()) / scale
        worst = max(worst, rel)
        if not (got.device == x.device and rel <= CONV_TOL):
            raise AssertionError(f"conv3x3 halo rows{(n, h, w, ci, co)} on other cards: rel "
                                 f"err {rel} > {CONV_TOL}")
    # the same in bf16: the bf16 kernel's staging reads its rows on other
    # cards, within one bf16 ulp of the plain version
    bf = torch.bfloat16
    misses16 = 0
    for n, h, w, ci, co in [(1, 512, 2048, 3, 16), (2, 9, 33, 16, 16), (1, 64, 256, 64, 64),
                            (1, 32, 128, 128, 128), (1, 17, 40, 32, 3), (1, 1, 64, 32, 24)]:
        x = (bench.rand(n, h, w, ci) - 0.5).to(bf)
        up = (bench.rand(n, 3, w, ci) - 0.5).to(bf).to("cuda:1")
        down = (bench.rand(n, 2, w, ci) - 0.5).to(bf).to(f"cuda:{n_cards - 1}")
        wt = ((bench.rand(3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)).to(bf)
        b = (bench.rand(co) - 0.5).to(bf)
        got = kc.conv3x3_reflect(x, wt, b, True, top=up[:, -1:], bot=down[:, :1]).float()
        ref = kc.conv3x3_reflect.plain(x, wt, b, True, top=up[:, -1:], bot=down[:, :1]).float()
        torch.cuda.synchronize()
        bound = torch.clamp(ref.abs() * BF16_ULP, min=BF16_FLOOR * float(ref.abs().max()))
        misses = int(((got - ref).abs() > bound).sum())
        misses16 += misses
        if misses:
            raise AssertionError(f"bf16 conv3x3 halo rows{(n, h, w, ci, co)} on other cards: "
                                 f"{misses} outputs past one bf16 ulp")
    pc16 = WCTEngine(mode="16x", space=SHARDS, devices=spread, dtype=bf)
    with torch.inference_mode():
        img16, sty16 = pc16._prep(c2k), pc16._prep(s2k)
        pc16_out, pc16_counts = per_conv_run(kc, pc16, img16, sty16)
        for d in range(n_cards):
            torch.cuda.synchronize(d)
        db_pc16 = psnr_device(torch, pc16_out.to("cuda:0"),
                              WCTEngine(mode="16x", dtype=bf).stylize_device(img16, sty16))
        del pc16_out
    pc16_timed = per_conv_timing(torch, kc, pc16, img16, sty16, "cross-card (bf16)")
    del img16, sty16
    per_conv = WCTEngine(mode="16x", space=SHARDS, devices=spread)
    with torch.inference_mode():
        img2k, sty2k = per_conv._prep(c2k), per_conv._prep(s2k)
        pc_out, pc_counts = per_conv_run(kc, per_conv, img2k, sty2k)
        for d in range(n_cards):
            torch.cuda.synchronize(d)
        db_pc = psnr_device(torch, pc_out.to("cuda:0"),
                            WCTEngine(mode="16x").stylize_device(img2k, sty2k))
        del pc_out
    pc_timed = per_conv_timing(torch, kc, per_conv, img2k, sty2k, "cross-card")
    del img2k, sty2k
    log(f"cross-card: conv3x3 with halo rows on other cards vs its plain version at 6 shapes, "
        f"max rel err {worst:.3e} (tol {CONV_TOL}); the per-conv 2048^2 cascade on {spread} vs "
        f"the plain one {db_pc:.2f} dB (min {PSNR_MIN_DB}), launches {pc_counts}")
    pc_plan = sum(per_conv_calls(per_conv.pyramid, per_conv.stages, [2048 // SHARDS] * SHARDS,
                                 2048).values())
    if not (db_pc >= PSNR_MIN_DB and pc_counts == {"halo_exchange_rows": 0, "halo_fill_rows": 0,
                                                   "conv3x3_halo": pc_plan}):
        raise AssertionError(f"cross-card per-conv cascade: {db_pc:.2f} dB, launches "
                             f"{pc_counts}, predicted {pc_plan} halo convs")
    log(f"cross-card: bf16 conv3x3 with halo rows on other cards vs its plain version at 6 "
        f"shapes, none past one bf16 ulp; the bf16 per-conv 2048^2 cascade on {spread} vs the "
        f"bf16 plain one {db_pc16:.2f} dB (min {BF16_SHARD_MIN_DB}), launches {pc16_counts}")
    if not (db_pc16 >= BF16_SHARD_MIN_DB and pc16_counts == {"halo_exchange_rows": 0,
                                                            "halo_fill_rows": 0,
                                                            "conv3x3_halo": pc_plan}):
        raise AssertionError(f"cross-card bf16 per-conv cascade: {db_pc16:.2f} dB, launches "
                             f"{pc16_counts}, predicted {pc_plan} halo convs")
    engine = WCTEngine(mode="16x", space=SHARDS, slab_rows=SHARD_SLAB, devices=spread)
    out = {"main": sharded_main_path(torch, kc, engine, c_uhd, s2k, calls_sh,
                                     "phase 3c (cross-card)"), "peer": peer,
           "halo_conv_max_rel_err": worst, "per_conv_2048_psnr_db": db_pc,
           "per_conv_launches": pc_counts, "per_conv_2048": pc_timed,
           "bf16_halo_conv_ulp_misses": misses16, "bf16_per_conv_2048_psnr_db": db_pc16,
           "bf16_per_conv_launches": pc16_counts, "bf16_per_conv_2048": pc16_timed}
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


def per_conv_timing(torch, kc, engine, img, sty, label) -> dict:
    """The warm per-conv sharded cascade on device maps: the median of 5
    (host clock around runs synchronised on every card of the mesh, and when
    the host had enqueued all work), its launches (counters zeroed around
    one run), peak memory per card, and, on one card, one profiled run's
    device busy time and idle share (the profile spans one card)."""
    cards = sorted({torch.device(d).index for d in engine.mesh.devices[0]})

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    with torch.inference_mode():
        engine.stylize_device(img, sty)   # warm
        _, halo = per_conv_run(kc, engine, img, sty)
        launches = {**_counts(kc), **{k.__name__: k.launches for k in kc.BF16_KERNELS
                                      if k.launches}, **halo}
        sync()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        resident = torch.cuda.memory_allocated(cards[0]) / 2**30
        runs, enqueued = [], []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            engine.stylize_device(img, sty)
            enqueued.append((time.perf_counter() - t0) * 1e3)
            sync()
            runs.append((time.perf_counter() - t0) * 1e3)
        peaks = [torch.cuda.max_memory_allocated(d) / 2**30 for d in cards]
    prof = (profile_cascade(torch, engine, img, sty, label) if len(cards) == 1
            else {"busy_ms": None})
    out = {"shape": list(img.shape[1:3]), "cards": len(cards), "runs_ms": runs,
           "median_ms": statistics.median(runs), "enqueued_ms": enqueued,
           "peak_gib": max(peaks), "peak_gib_per_card": peaks,
           "resident_before_gib": resident, "launches": launches,
           "busy_ms": prof["busy_ms"], "idle_share": prof.get("idle_share"),
           "conv3x3_ms": prof.get("conv3x3_ms"), "profile": prof}
    busy = "not measured" if prof["busy_ms"] is None else (
        f"{prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f}")
    where = "one card" if len(cards) == 1 else f"{len(cards)} cards"
    log(f"{label}: warm per-conv cascade {img.shape[1]}x{img.shape[2]} (space={SHARDS} on "
        f"{where}) {out['median_ms']:.2f} ms (runs {', '.join(f'{r:.2f}' for r in runs)}; "
        f"the host had enqueued all work after {', '.join(f'{r:.2f}' for r in enqueued)} ms), "
        f"busy {busy}, peak GiB per card {', '.join(f'{p:.2f}' for p in peaks)} ({resident:.2f} "
        f"GiB held before it on the first); launches {launches}")
    return out


# ---- phase 5e: packed, each encoder's conv0 folded into its conv1_1 ------------

def conv0_products(torch, eng, img, sty, **kw) -> int:
    """The ``conv0`` products one cascade runs: ``x @ w`` with conv0's 3x3
    matrix (``ops/conv.py:conv1x1``), read from the profiler's recorded
    input shapes (no other product of the cascades takes a 3x3 matrix)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU],
                                         record_shapes=True) as prof:
        eng.stylize_device(img, sty, **kw)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.name == "aten::matmul"
               and len(e.input_shapes) > 1 and list(e.input_shapes[1]) == [3, 3])


def conv0_plan(eng, h: int, w: int, itemsize: int) -> int:
    """``conv0`` products of one unfolded slab or slab-in-shard cascade on an
    (h, w) content, the style's statistics cached: an encoder run a window
    in pass 1, and in pass 2 again unless the stage's features are kept
    (the slab-in-shard path encodes every window again)."""
    from collaborative_distillation_tpu_torch.parallel.spatial import shard_rows
    from collaborative_distillation_tpu_torch.wct.slab import FEATURE_CACHE_BYTES
    if eng.slab is not None:
        return sum(len(list(eng.slab._slabs(h, k)))
                   * (1 if eng.slab.feature_bytes(k, h, w, itemsize) <= FEATURE_CACHE_BYTES
                      else 2)
                   for k in eng.stages)
    slab = eng._tiled_slab
    return len(eng.stages) * 2 * sum(-(-r // slab) for r in shard_rows(h, slab, SHARDS))


def folded_conv_checks(torch, kc, eng, img) -> list:
    """conv3x3 (float32, or the bf16 ring kernel's Cin-3 ``ck8_*`` templates)
    against its plain version with each stage's folded ``conv1_1`` (weights
    about 255x conv0's absence, the bias hundreds) on the content's first
    window of that stage, at the tolerances of phases 2 and 10a."""
    rows_out = []
    bf = img.dtype == torch.bfloat16
    conv = kc.conv3x3_reflect_bf16 if bf else kc.conv3x3_reflect
    for k in eng.stages:
        spec = eng.pyramid[k]["enc_spec"]
        p = eng.slab.packed_params[k]["enc"][spec.layers[0].name]
        _, rows, _, _ = next(eng.slab._slabs(img.shape[1], k))
        x = img[:, :rows].contiguous()
        relu = spec.layers[0].relu
        got, ref = conv(x, p["w"], p["b"], relu), conv.plain(x, p["w"], p["b"], relu)
        g, r = got.float(), ref.float()
        err = float((g - r).abs().max())
        if bf:
            bound = torch.clamp(r.abs() * BF16_ULP, min=BF16_FLOOR * float(r.abs().max()))
            misses = int(((g - r).abs() > bound).sum())
            tol = None
        else:
            tol = CONV_TOL * float(x.abs().max() * p["w"].abs().sum(dim=(0, 1, 2)).max()
                                   + p["b"].abs().max())
            misses = int(err > tol)
        rows_out.append({"stage": k, "shape": list(x.shape) + [int(p["w"].shape[-1])],
                         "max_abs_err": err, "tol": tol, "misses": misses,
                         "max_abs_w": float(p["w"].abs().max()),
                         "max_abs_b": float(p["b"].abs().max())})
        del got, ref, g, r
        if misses:
            raise AssertionError(f"phase 5e: folded conv1_1 of stage {k} {tuple(x.shape)}: "
                                 f"{misses} outputs past the tolerance (max abs err {err})")
    return rows_out


def packed_phase(torch, kc, WCTEngine, c_uhd, s2k, smi) -> dict:
    """5e: the UHD slab and slab-in-shard cascades with each encoder's conv0
    folded into its conv1_1 (``packed``, the engine's default) against
    ``packed=False``, float32 and bf16, in turns on one card (see the
    module docstring)."""
    bf = torch.bfloat16
    shard_kw = dict(space=SHARDS, slab_rows=SHARD_SLAB, devices=["cuda:0"] * SHARDS)
    cases = (("UHD slab", torch.float32, dict(slab_rows=UHD_SLAB)),
             ("UHD slab", bf, dict(slab_rows=UHD_SLAB)),
             ("UHD slab-in-shard", torch.float32, shard_kw),
             ("UHD slab-in-shard", bf, shard_kw))
    out, t0_phase = {}, time.perf_counter()
    f32_out = {}   # the float32 folded output of each path, the bf16 cases' yardstick
    for path, dtype, kw in cases:
        name = f"{path} {'bf16' if dtype == bf else 'f32'}"
        engs = {p: WCTEngine(mode="16x", dtype=dtype, packed=p, **kw) for p in (True, False)}
        if not (engs[True].packed and not engs[False].packed):
            raise AssertionError(f"phase 5e: {name}: packed flags {engs}")
        img, sty = engs[True]._prep(c_uhd), engs[True]._prep(s2k)
        h, w = img.shape[1:3]
        res = {"checks": folded_conv_checks(torch, kc, engs[True], img)
               if engs[True].slab is not None else []}
        with torch.inference_mode():
            # warm, and the style's statistics cached under the key
            outs = {p: e.stylize_device(img, sty, style_key="5e") for p, e in engs.items()}
            db = psnr_device(torch, outs[True], outs[False])
            finite = all(bool(torch.isfinite(o).all()) for o in outs.values())
            if dtype == bf:
                vs32 = {p: psnr_device(torch, o, f32_out[path]) for p, o in outs.items()}
                res["psnr_vs_f32_db"] = {"folded": vs32[True], "unfolded": vs32[False]}
                ok_db = (vs32[True] >= vs32[False] - BF16_FOLD_COST_DB
                         and min(vs32.values()) >= BF16_PSNR_MIN_DB)
                del f32_out[path]
            else:
                f32_out[path] = outs[True]
                ok_db = db >= PSNR_MIN_DB
            del outs
            runs = {True: [], False: []}
            for p in (True, False, False, True, True, False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engs[p].stylize_device(img, sty, style_key="5e")
                torch.cuda.synchronize()
                runs[p].append((time.perf_counter() - t0) * 1e3)
            for p, e in engs.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated() / 2**30
                e.stylize_device(img, sty, style_key="5e")
                torch.cuda.synchronize()
                res[p] = {"runs_ms": runs[p], "median_ms": statistics.median(runs[p]),
                          "spread_ms": max(runs[p]) - min(runs[p]),
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "held_before_gib": held}
        for p, e in engs.items():
            prof = profile_cascade(torch, e, img, sty, f"phase 5e: {name} packed={p}",
                                   style_key="5e")
            res[p].update(idle_share=prof.get("idle_share"), busy_ms=prof["busy_ms"],
                          conv3x3_ms=prof.get("conv3x3_ms"),
                          bf16_conv_ms=prof.get("bf16_conv_ms"),
                          conv0_products=conv0_products(torch, e, img, sty, style_key="5e"))
        want0 = conv0_plan(engs[False], h, w, img.element_size())
        res.update(psnr_folded_vs_unfolded_db=db, conv0_predicted_unfolded=want0)
        out[name] = res
        idle = lambda r: "not measured" if r["idle_share"] is None else f"{r['idle_share']:.3f}"
        held = (f"folded vs packed=False PSNR {db:.2f} dB (min {PSNR_MIN_DB})" if dtype != bf
                else f"folded vs packed=False PSNR {db:.2f} dB; against the float32 folded "
                     f"output folded {res['psnr_vs_f32_db']['folded']:.2f} dB, unfolded "
                     f"{res['psnr_vs_f32_db']['unfolded']:.2f} dB (the folded at most "
                     f"{BF16_FOLD_COST_DB} dB below the unfolded, both above "
                     f"{BF16_PSNR_MIN_DB})")
        log(f"phase 5e: {name} {h}x{w} ({smi}): {held}; warm, style statistics cached, in "
            f"turns: folded "
            f"{res[True]['median_ms']:.2f} ms (runs "
            f"{', '.join(f'{r:.2f}' for r in res[True]['runs_ms'])}, spread "
            f"{res[True]['spread_ms']:.2f}) against {res[False]['median_ms']:.2f} ms (runs "
            f"{', '.join(f'{r:.2f}' for r in res[False]['runs_ms'])}, spread "
            f"{res[False]['spread_ms']:.2f}); peaks {res[True]['peak_gib']:.2f} / "
            f"{res[False]['peak_gib']:.2f} GiB; idle shares {idle(res[True])} / "
            f"{idle(res[False])}; conv0 products {res[True]['conv0_products']} / "
            f"{res[False]['conv0_products']} (predicted 0 / {want0})"
            + (f"; folded conv1_1 kernel vs plain at stages {[c['stage'] for c in res['checks']]}"
               f" (|w| to {max(c['max_abs_w'] for c in res['checks']):.1f}, |b| to "
               f"{max(c['max_abs_b'] for c in res['checks']):.1f}): max abs err "
               f"{max(c['max_abs_err'] for c in res['checks']):.3e}, none past the "
               f"tolerance" if res["checks"] else ""))
        if not (ok_db and finite and res[True]["conv0_products"] == 0
                and res[False]["conv0_products"] == want0 > 0):
            raise AssertionError(
                f"phase 5e: {name}: {held}, finite {finite}, conv0 products "
                f"{res[True]['conv0_products']} / {res[False]['conv0_products']} (want 0 / "
                f"{want0})")
        del engs, img, sty
        torch.cuda.empty_cache()
    out["phase5e_s"] = time.perf_counter() - t0_phase
    log(f"phase 5e: {out['phase5e_s']:.1f} s")
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


def _wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def nvjpeg_checks(torch, c2k, c_uhd) -> dict:
    """Phase 6a: nvJPEG against libjpeg's decodes in the fixture, its
    quality-95 tables and round trips, and its decode and encode walls at
    2048^2 and UHD with its own memory (see the module docstring)."""
    from collaborative_distillation_tpu_torch.data import jpeg_header
    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    from collaborative_distillation_tpu_torch.utils.transfer import push
    with np.load(os.path.join(HERE, "collaborative_distillation_tpu_torch", "data",
                              "jpeg_fixture.npz")) as d:
        fx = {k: d[k] for k in d.files}
    out: dict = {"version": nj.version()}
    planes = nj.decode_jpeg_yuv420(fx["in1_jpeg"].tobytes())
    out["planes"] = {}
    for label, got, want in zip(("y", "cbcr"), planes, (fx["in1_y"], fx["in1_cbcr"])):
        diff = np.abs(got.cpu().numpy().astype(np.int16) - want)
        out["planes"][label] = {"max": int(diff.max()), "mean": float(diff.mean())}
    out["rgb"] = {}
    for name in JPEG_FIXTURE_FILES:
        got = nj.decode_jpeg(fx[f"{name}_jpeg"].tobytes()).cpu().numpy()
        want = fx[f"{name}_rgb"]
        out["rgb"][name] = {"shape": list(got.shape),
                            "max": int(np.abs(got.astype(np.int16) - want).max()),
                            "psnr_db": psnr(got / 255.0, want / 255.0)}
    log(f"phase 6a: nvJPEG {out['version']} vs libjpeg on the fixture: 512^2 4:2:0 planes "
        f"max/mean |diff| Y {out['planes']['y']['max']} / {out['planes']['y']['mean']:.4f}, "
        f"CbCr {out['planes']['cbcr']['max']} / {out['planes']['cbcr']['mean']:.4f} (max "
        f"{NVJPEG_PLANE_MAX}, mean {NVJPEG_PLANE_MEAN}); RGB PSNR (max |diff|) " + ", ".join(
            f"{k} {v['psnr_db']:.2f} dB ({v['max']})" for k, v in out["rgb"].items())
        + f" (min {PSNR_MIN_DB})")
    if any(v["max"] > NVJPEG_PLANE_MAX or v["mean"] > NVJPEG_PLANE_MEAN
           for v in out["planes"].values()):
        raise AssertionError(f"nvJPEG planes vs libjpeg {out['planes']}")
    if any(not v["psnr_db"] >= PSNR_MIN_DB or v["shape"] != list(fx[f"{k}_rgb"].shape)
           for k, v in out["rgb"].items()):
        raise AssertionError(f"nvJPEG RGB vs libjpeg {out['rgb']}")
    # the encoder: its q95 tables, and both encoders' q95 files of the same
    # planes decoded on the card against the planes
    y, cbcr = push(fx["content_y"], "cuda"), push(fx["content_cbcr"], "cuda")
    body = nj.encode_jpeg_yuv420(y, cbcr, quality=95)
    hdr = jpeg_header.parse(body)
    tables = [hdr.quant_tables[c.tq].tolist() for c in hdr.components]
    ijg = [t.tolist() for t in jpeg_header.ijg_quant_tables(95)]
    out["q95_tables_equal_ijg"] = tables == [ijg[0], ijg[1], ijg[1]]
    out["q95"] = {}
    for label, data in (("nvjpeg", body), ("libjpeg", fx["content_q95"].tobytes())):
        yo, co = nj.decode_jpeg_yuv420(data)
        out["q95"][label] = {"bytes": len(data),
                             "y_db": psnr(yo.cpu().numpy() / 255.0, fx["content_y"] / 255.0),
                             "cbcr_db": psnr(co.cpu().numpy() / 255.0, fx["content_cbcr"] / 255.0)}
    log(f"phase 6a: nvJPEG q95 DQT tables equal the IJG tables of q95: "
        f"{out['q95_tables_equal_ijg']}; q95 files of the 512^2 content planes decoded on the "
        f"card vs the planes: " + "; ".join(
            f"{k} {v['bytes']} B, Y {v['y_db']:.2f} dB, CbCr {v['cbcr_db']:.2f} dB"
            for k, v in out["q95"].items()))
    if not out["q95_tables_equal_ijg"]:
        raise AssertionError(f"nvJPEG q95 tables {tables} != IJG {ijg}")
    if any(not (v["y_db"] >= PSNR_MIN_DB and v["cbcr_db"] >= PSNR_MIN_DB)
           for v in out["q95"].values()):
        raise AssertionError(f"q95 round trips {out['q95']}")
    # walls: host clock around a synchronized call (the default backend
    # decodes Huffman on the host), after one warm call each, in turns
    out["walls_ms"] = {}
    nj.memory(reset_peak=True)
    for label, c, reps in (("2048^2", c2k, 5), ("UHD", c_uhd, 3)):
        rgb = push(c, "cuda")
        data = nj.encode_jpeg(rgb, quality=95)
        yp, cp = nj.decode_jpeg_yuv420(data)
        calls = {"decode planes": lambda: nj.decode_jpeg_yuv420(data),
                 "decode rgb": lambda: nj.decode_jpeg(data),
                 "encode planes": lambda: nj.encode_jpeg_yuv420(yp, cp, quality=95),
                 "encode rgb": lambda: nj.encode_jpeg(rgb, quality=95)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        walls: dict = {k: [] for k in calls}
        for k, fn in calls.items():
            fn()
        for _ in range(reps):
            for k, fn in calls.items():
                walls[k].append(_wall_ms(torch, fn))
        out["walls_ms"][label] = {
            "bytes": len(data), "torch_peak_over_inputs_gib":
                (torch.cuda.max_memory_allocated() - base) / 2**30,
            **{k: {"median": statistics.median(v), "runs": v} for k, v in walls.items()}}
        log(f"phase 6a: nvJPEG {label} q95 ({len(data)} B): " + "; ".join(
            f"{k} {statistics.median(v):.2f} ms (runs {', '.join(f'{x:.2f}' for x in v)})"
            for k, v in walls.items()))
        del rgb, yp, cp
    out["nvjpeg_memory"] = nj.memory()
    log(f"phase 6a: nvJPEG's own allocations (not in torch's peaks): device "
        f"{out['nvjpeg_memory']['device'] / 2**20:.1f} MiB now, peak "
        f"{out['nvjpeg_memory']['device_peak'] / 2**20:.1f} MiB; pinned "
        f"{out['nvjpeg_memory']['pinned'] / 2**20:.1f} MiB now, peak "
        f"{out['nvjpeg_memory']['pinned_peak'] / 2**20:.1f} MiB; torch's peak over the "
        f"inputs while coding UHD {out['walls_ms']['UHD']['torch_peak_over_inputs_gib']:.3f} GiB")
    return out


def host_boundary(torch, kc, slab_eng, eng, c_uhd, c2k, s2k, expect_uhd) -> dict:
    """Phase 6: the host boundary on the card (see the module docstring)."""
    from collaborative_distillation_tpu_torch.data import native_codec as nc
    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    from collaborative_distillation_tpu_torch.utils.colorspace import (rgb_to_yuv420_host,
                                                                       yuv420_to_rgb_host)
    from collaborative_distillation_tpu_torch.utils.transfer import fetch, push
    dev = eng.device
    out: dict = {"codec_built": nc.available(), "codec_reason": nc.unavailable_reason()}
    # ---- 6a: nvJPEG, and the JPEG endpoints at UHD (the slice's main path)
    log(f"phase 6a: the CPU's codec (libjpeg, native/imgcodec.cpp) here: "
        f"{'built' if out['codec_built'] else out['codec_reason']}; a CUDA engine never uses it")
    out["nvjpeg"] = nvjpeg_checks(torch, c2k, c_uhd)
    jpeg = nj.encode_jpeg(push(c_uhd, dev), quality=95)
    y_dev, c_dev = nj.decode_jpeg_yuv420(jpeg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    nj.memory(reset_peak=True)
    _zero(kc)
    t0 = time.perf_counter()
    body = slab_eng.stylize_jpeg(jpeg, s2k)
    jpeg_s = time.perf_counter() - t0
    counts = _counts(kc)
    peak = {"torch_gib": torch.cuda.max_memory_allocated() / 2**30,
            "resident_before_gib": resident, "nvjpeg_device_gib": nj.memory()["device_peak"] / 2**30,
            "nvjpeg_pinned_gib": nj.memory()["pinned_peak"] / 2**30}
    log(f"phase 6a: stylize_jpeg {UHD_H}x{UHD_W} peak memory: torch {peak['torch_gib']:.2f} GiB "
        f"({resident:.2f} GiB held before it), and nvJPEG's own (not in torch's count) device "
        f"{peak['nvjpeg_device_gib']:.3f} GiB, pinned {peak['nvjpeg_pinned_gib']:.3f} GiB")
    whole = nj.encode_jpeg_yuv420(*slab_eng.stylize_planes(y_dev, c_dev, s2k, on_device=True),
                                  quality=95)
    planes_body = slab_eng.stylize_planes_jpeg(y_dev, c_dev, s2k)
    log(f"phase 6a: stylize_jpeg {UHD_H}x{UHD_W} through nvJPEG ({len(jpeg)} B in, "
        f"{0 if body is None else len(body)} B out) in {jpeg_s:.3f} s; launches {counts}, "
        f"predicted {expect_uhd}; bytes equal to stylize_planes(on_device=True) + "
        f"encode_jpeg_yuv420: {body == whole}; stylize_planes_jpeg's: {planes_body == whole}")
    if counts != expect_uhd or any(v <= 0 for n, v in counts.items()
                                   if n not in SHARDED_ONLY):
        raise AssertionError(f"stylize_jpeg launches {counts} != predicted {expect_uhd}")
    if body is None or body != whole or planes_body != whole:
        raise AssertionError("stylize_jpeg bytes differ from stylize_planes + encode")
    rgb = nj.decode_jpeg(body).cpu().numpy()
    change = float(np.abs(rgb.astype(np.float32) - c_uhd).mean()) / 255.0
    if not (rgb.shape == c_uhd.shape and change > 0.02):
        raise AssertionError(f"stylize_jpeg output {rgb.shape}, mean change {change}")
    # the host planes (the streamed tail) against the device planes of the whole cascade
    y, cbcr = fetch(y_dev), fetch(c_dev)
    host = slab_eng.stylize_planes(y, cbcr, s2k)
    dev_planes = slab_eng.stylize_planes(y_dev, c_dev, s2k, on_device=True)
    streamed_diff = max(int(np.abs(a.astype(np.int16) - b.cpu().numpy()).max())
                        for a, b in zip(host, dev_planes))
    log(f"phase 6a: stylize_planes streamed to host planes vs on_device: max level diff "
        f"{streamed_diff}")
    if streamed_diff > 1:
        raise AssertionError(f"streamed vs device planes: {streamed_diff} levels")
    out.update(jpeg_s=jpeg_s, launches=counts, jpeg_in_bytes=len(jpeg), peak_memory=peak,
               jpeg_out_bytes=len(body), mean_change=change,
               streamed_vs_device_planes=streamed_diff)
    del y_dev, c_dev, dev_planes
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
    for k in kc.KERNELS + kc.BF16_KERNELS:
        k.launches = 0
    kc.conv3x3_reflect.halo_launches = 0
    kc.conv3x3_reflect_bf16.halo_launches = 0
    kc.conv3x3_reflect.by_template.clear()
    kc.conv3x3_reflect_bf16.by_template.clear()


def per_conv_run(kc, engine, img, sty):
    """One per-conv sharded cascade on device maps, the counters zeroed
    around it: its output, and its exchange and fill launches and halo convs
    (float32 or bf16)."""
    _zero(kc)
    out = engine.stylize_device(img, sty)
    return out, {"halo_exchange_rows": kc.halo_exchange_rows.launches,
                 "halo_fill_rows": kc.halo_fill_rows.launches,
                 "conv3x3_halo": (kc.conv3x3_reflect.halo_launches
                                  + kc.conv3x3_reflect_bf16.halo_launches)}


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
    """A PNG or JPEG response or file as a host uint8 image (JPEG by nvJPEG)."""
    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    from collaborative_distillation_tpu_torch.data.png import decode_png
    return decode_png(body) if ctype == "image/png" else nj.decode_jpeg(body).cpu().numpy()


def _same_as(body, ctype, want, label) -> None:
    """A response or file against the engine's direct uint8 result: a PNG's
    pixels bit-equal, a JPEG's bytes equal to the card's ``encode_jpeg`` of
    it (nvJPEG from the port's 4:2:0 planes)."""
    from collaborative_distillation_tpu_torch.data import jpeg
    from collaborative_distillation_tpu_torch.data.png import decode_png
    same = (np.array_equal(decode_png(body), want) if ctype == "image/png"
            else body == jpeg.encode_jpeg(want, "cuda", quality=95))
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
        if not (health["ok"] and health["device"] == str(eng.device)
                and health["codec"] == "available" and health["jpeg_codec"] == "nvjpeg"):
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
        out["jpeg_requests"] = _jpeg_requests(torch, kc, srv, eng, c2k, s2k, ka, one)
    finally:
        srv.close()
    return out


def _jpeg_requests(torch, kc, srv, eng, c2k, s2k, key, one) -> dict:
    """7a: JPEG bodies at 2048^2, one at a time: nvJPEG decodes each body
    and encodes each response; launches per request, the first response's
    bytes against the engine's direct call on what the server read, client
    walls and the Server-Timing legs."""
    from collaborative_distillation_tpu_torch.data import jpeg
    body_in = jpeg.encode_jpeg(c2k, "cuda", quality=95)
    read = jpeg.decode_jpeg(body_in, "cuda").cpu().numpy()   # what the server reads
    walls, legs = [], []
    for i in range(JPEG_REQUESTS):
        _zero(kc)
        t0 = time.perf_counter()
        _, body, hdr = _http(f"{srv.url}/stylize?style=a", body_in)
        walls.append((time.perf_counter() - t0) * 1e3)
        legs.append(_legs(hdr))
        if _counts(kc) != one or hdr["Content-Type"] != "image/jpeg":
            raise AssertionError(f"phase 7a: JPEG request {i}: {hdr['Content-Type']}, "
                                 f"launches {_counts(kc)} != {one}")
        if i == 0:
            want = eng.stylize(read, s2k, style_key=key, as_uint8=True)
            _same_as(body, "image/jpeg", want, "phase 7a: JPEG request")
            db = _psnr_u8(torch, _decoded(body, "image/jpeg"),
                          eng.stylize(c2k, s2k, style_key=key, as_uint8=True))
    order = sorted(walls)
    out = {"in_bytes": len(body_in), "out_bytes": len(body), "walls_ms": walls,
           "p50_ms": order[len(order) // 2], "p95_ms": order[min(len(order) - 1,
                                                                int(len(order) * 0.95))],
           "legs_ms": {k: statistics.median(x[k] for x in legs) for k in legs[0]},
           "psnr_vs_png_path_db": db}
    log(f"phase 7a: {JPEG_REQUESTS} JPEG requests at 2048^2 ({len(body_in)} B in, "
        f"{len(body)} B out), each image/jpeg with the plan's launches {one}, the first equal "
        f"to the engine's direct call: client p50 {out['p50_ms']:.1f} ms, p95 "
        f"{out['p95_ms']:.1f} ms (walls {', '.join(f'{w:.1f}' for w in walls)}); "
        f"Server-Timing medians {out['legs_ms']} ms; decoded vs the uint8 output of the "
        f"unencoded content {db:.2f} dB (min {JPEG_PSNR_MIN_DB})")
    if not db >= JPEG_PSNR_MIN_DB:
        raise AssertionError(f"phase 7a: JPEG request {db:.2f} dB")
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
        # JPEG bodies: nvJPEG decodes the content and encodes the response
        from collaborative_distillation_tpu_torch.data import jpeg
        want = _totals(kc, slab_path_calls(eng.pyramid, eng.stages, cas.margins, cas.slab_rows,
                                           UHD_H, UHD_W, 2048, 2048, FEATURE_CACHE_BYTES,
                                           style=False)[0])
        jpeg_in = jpeg.encode_jpeg(c_uhd, "cuda", quality=95)
        walls, legs = [], []
        for i in range(3):
            _zero(kc)
            t0 = time.perf_counter()
            _, jbody, jhdr = _http(srv.url + "/stylize?style=s", jpeg_in)
            walls.append((time.perf_counter() - t0) * 1e3)
            legs.append(_legs(jhdr))
            if _counts(kc) != want or jhdr["Content-Type"] != "image/jpeg":
                raise AssertionError(f"phase 7b: UHD JPEG request {i}: {jhdr['Content-Type']}, "
                                     f"launches {_counts(kc)} != {want}")
        jgot = _decoded(jbody, "image/jpeg")
        jdb = _psnr_u8(torch, jgot, ref_u8)
        out["jpeg"] = {"in_bytes": len(jpeg_in), "out_bytes": len(jbody), "walls_ms": walls,
                       "legs_ms": legs, "psnr_vs_phase_3b_db": jdb}
        log(f"phase 7b: {UHD_H}x{UHD_W} JPEG requests ({len(jpeg_in)} B in, {len(jbody)} B "
            f"out), each image/jpeg with the slab plan's launches (style cached) {want}: client "
            f"walls {', '.join(f'{w:.0f}' for w in walls)} ms; Server-Timing "
            f"{'; '.join(str(x) for x in legs)} ms; vs phase 3b's output PSNR {jdb:.2f} dB "
            f"(min {JPEG_PSNR_MIN_DB})")
        if jgot.shape != c_uhd.shape or not jdb >= JPEG_PSNR_MIN_DB:
            raise AssertionError(f"UHD JPEG response {jgot.shape}, {jdb:.2f} dB")
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
    # s2 as a JPEG, written and read back by nvJPEG: the CLI stylizes what it reads
    os.remove(os.path.join(tmp, "style", "s2.png"))
    save_image(styles["s2"], os.path.join(tmp, "style", "s2.jpg"))
    styles["s2"] = read_image(os.path.join(tmp, "style", "s2.jpg"))
    log(f"phase 7d: style s2 written and read back as .jpg by nvJPEG: PSNR "
        f"{_psnr_u8(torch, styles['s2'], np.ascontiguousarray(s2k[:, ::-1])):.2f} dB")
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


def write_original_weights(torch, root) -> None:
    """A seeded mode-original pyramid (stages 5..1, encoder then decoder,
    ``torch.Generator`` seed 0) as ``root/original/{e,d}<k>.npz``."""
    from collaborative_distillation_tpu_torch.models.vgg import init_params
    from collaborative_distillation_tpu_torch.models.zoo import stage_specs
    os.makedirs(os.path.join(root, "original"))
    gen = torch.Generator().manual_seed(0)
    for k in (5, 4, 3, 2, 1):
        for spec, name in zip(stage_specs("original", k), (f"e{k}", f"d{k}")):
            p = init_params(spec, gen)
            np.savez(os.path.join(root, "original", name + ".npz"),
                     **{f"{n}/{kind}": t.numpy() for n, leaf in p.items()
                        for kind, t in leaf.items()})


def original_cascade(torch, teng, c512, s512, size=ORIGINAL_HW) -> dict:
    """7f: the warm mode-original cascade (``teng``) on the photo pair
    reflect-tiled to size^2 content and style: median of 3 after one
    warm-up, and its peak memory."""
    with torch.inference_mode():
        img = teng._prep(reflect_tile(torch, c512, size))
        sty = teng._prep(reflect_tile(torch, s512, size))
        out = teng.stylize_device(img, sty)
        finite = bool(torch.isfinite(out).all())
        del out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2**30
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            teng.stylize_device(img, sty)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
    return {"size": size, "runs": runs, "median": statistics.median(runs), "peak_gib": peak,
            "resident_before_gib": resident, "finite": finite}


def teacher_widths(torch, kc, WCTEngine, c512, s512, tmp) -> dict:
    """7f: a seeded ``original`` pyramid (teacher widths, Cin/Cout to 512)."""
    from collaborative_distillation_tpu_torch.cli import stylize as cli
    from collaborative_distillation_tpu_torch.models.vgg import apply_decoder, apply_encoder
    from collaborative_distillation_tpu_torch.utils.image import (jpeg_or_png, read_image,
                                                                  save_image)
    root = os.path.join(tmp, "weights")
    write_original_weights(torch, root)
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
    # the warm cascade at ORIGINAL_HW^2, and one run's launches by template
    casc = original_cascade(torch, teng, c512, s512)
    calls_big, _ = path_calls(tpyr, teng.stages, ORIGINAL_HW, ORIGINAL_HW)
    with torch.inference_mode():
        img = teng._prep(reflect_tile(torch, c512, ORIGINAL_HW))
        sty = teng._prep(reflect_tile(torch, s512, ORIGINAL_HW))
        _zero(kc)
        teng.stylize_device(img, sty)
        torch.cuda.synchronize()
        del img, sty
    _check_counts(f"phase 7f: original cascade {ORIGINAL_HW}^2", _counts(kc),
                  _totals(kc, calls_big))
    casc["conv3x3_by_template"] = dict(kc.conv3x3_reflect.by_template)
    casc["teacher_width_launches"] = sum(n for s, n in original_conv_calls(ORIGINAL_HW).items()
                                         if teacher_width(s))
    if "first" in casc["conv3x3_by_template"] or not casc["finite"]:
        raise AssertionError(f"phase 7f: original cascade {casc}")
    log(f"phase 7f: original cascade {ORIGINAL_HW}^2 warm {casc['median']:.2f} ms (runs "
        f"{', '.join(f'{r:.2f}' for r in casc['runs'])}), peak {casc['peak_gib']:.2f} GiB "
        f"({casc['resident_before_gib']:.2f} held before it), output finite; conv3x3 launches "
        f"by template {casc['conv3x3_by_template']} ({casc['teacher_width_launches']} at "
        f"Cin or Cout 256/512)")
    return {"checks": len(checks), "widest_cin": widest, "conv_max_rel_err": worst_conv,
            "chain_rel_err": chain, "cli_s": cli_s, "card_vs_cpu_db": db,
            "cascade": casc}


# ---- phase 8: training ----------------------------------------------------------

TRAIN_STAGE, TRAIN_N, TRAIN_HW = 5, 16, 256   # cli.train's full width: stage 5 x 16 x 256^2
TRAIN_STEPS = 6
TRAIN_IMAGES = 48
# hand-written kernels, by the profiler's names; cuDNN's convolution kernels
# by theirs (every forward conv3x3 of the step is ours, so these are the
# backward's; "cf32" is the complex GEMM of its FFT convolutions); cuBLAS's
# GEMMs (conv0's and the aux adapters' x @ w, forward and backward) on their own
OUR_KERNEL_NAMES = (CONV3X3_NAMES, BF16_RING_KERNEL, "max_pool_2x2_kernel",
                    "upsample_nearest_2x_kernel")
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


def _card_and_cpu(torch, mode: str, dtype: str):
    """(cfg, card trainer, CPU trainer, batch) of one mode at stage 2 with
    the same seeded weights, and a seeded N = 2 64^2 batch."""
    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    from collaborative_distillation_tpu_torch.models.vgg import init_params
    from collaborative_distillation_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                                    student_spec)
    gen = torch.Generator().manual_seed(0)
    frozen = {"be": init_params(encoder_spec("original", 2), gen),
              "bd": init_params(decoder_spec("original", 2), gen),
              "se": init_params(encoder_spec("16x", 2, aux=True), gen)}
    cfg = TrainConfig(mode=mode, stage=2, compute_dtype=dtype)
    student = init_params(student_spec(cfg), gen)
    batch = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    return (cfg, *(Trainer(cfg, student, frozen, device=d) for d in ("cuda", "cpu")), batch)


def train_card_vs_cpu(torch) -> dict:
    """8b: one step of each mode on the card against the same step on the
    CPU: stage 2, N = 2, 64^2, the same seeded weights and batch."""
    out = {}
    for mode in ("wct_se", "wct_sd", "wct_sd_kd2sd"):
        cfg, card, cpu, batch = _card_and_cpu(torch, mode, "float32")
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
    """The stage-5 encoder and decoder passes of one training step, in order
    (``wct_sd`` with ``--lw_perc 0``; ``wct_sd_perc`` with its perceptual
    loss, the teacher encoder on the content and on the reconstruction)."""
    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    k = TRAIN_STAGE
    be, bd = encoder_spec("original", k), decoder_spec("original", k)
    se, sd = encoder_spec("16x", k, aux=True), decoder_spec("16x", k)   # aux: 1x1, no kernel
    return {"wct_se": [se, bd, be, be], "wct_sd": [se, sd], "wct_sd_perc": [se, sd, be, be],
            "wct_sd_kd2sd": [be, se, bd, sd, be]}[mode]


def train_conv_calls(mode: str) -> Counter:
    """{(N, H, W, Cin, Cout, relu): calls} of the conv3x3 launches of one
    training step at stage 5 x 16 x 256^2."""
    calls = Counter()
    for spec in _train_runs(mode):
        hh = TRAIN_HW if spec.kind == "encoder" else TRAIN_HW >> (TRAIN_STAGE - 1)
        for l in spec.layers:
            calls[(TRAIN_N, hh, hh, l.in_ch, l.out_ch, l.relu)] += 1
            hh = hh // 2 if l.pool_after else hh * 2 if l.unpool_after else hh
    return calls


def teacher_width(shape) -> bool:
    """A conv at the teachers' widths: Cin or Cout 256 or 512."""
    return max(shape[3], shape[4]) >= 256


def original_conv_calls(size: int) -> Counter:
    """{(1, H, W, Cin, Cout, relu): calls} of the conv3x3 launches of one
    mode-original cascade (stages 5..1) on a size^2 content and style."""
    from collaborative_distillation_tpu_torch.models.zoo import stage_specs
    stages = (5, 4, 3, 2, 1)
    pyr = {k: dict(zip(("enc_spec", "dec_spec"), stage_specs("original", k))) for k in stages}
    calls, _ = path_calls(pyr, stages, size, size)
    return Counter({s: n for (k, s), n in calls.items() if k == "conv3x3_reflect"})


def _train_launches(mode: str, bf16: bool = False) -> dict:
    """Kernel launches of one training step at stage 5, from the specs: every
    forward conv3x3, pool and upsample (the backward launches none); in
    bf16 on the bf16 kernels."""
    runs = _train_runs(mode)
    name = (lambda k: BF16_OF[k]) if bf16 else (lambda k: k)
    return {name("conv3x3_reflect"): sum(len(s.layers) for s in runs),
            name("max_pool_2x2"): sum(sum(l.pool_after for l in s.layers) for s in runs),
            name("upsample_nearest_2x"): sum(sum(l.unpool_after for l in s.layers)
                                             for s in runs)}


def train_pool_calls(mode: str) -> dict:
    """{kernel: {(N, H, W, C): calls}} of one training step's pools and
    upsamples at stage 5 x 16 x 256^2 (the float32 kernels' names)."""
    calls = {"max_pool_2x2": Counter(), "upsample_nearest_2x": Counter()}
    for spec in _train_runs(mode):
        hh = TRAIN_HW if spec.kind == "encoder" else TRAIN_HW >> (TRAIN_STAGE - 1)
        for l in spec.layers:
            if l.pool_after or l.unpool_after:
                kernel = "max_pool_2x2" if l.pool_after else "upsample_nearest_2x"
                calls[kernel][(TRAIN_N, hh, hh, l.out_ch)] += 1
                hh = hh // 2 if l.pool_after else hh * 2
    return calls


def _train_kernel_bound_ms(mode: str, bf16: bool = False) -> float:
    """The least time the card could take for one step's hand-written kernels:
    each conv3x3's FLOPs at the FP32 peak (bf16: the tensor cores' bf16
    peak) or its bytes at the HBM rate (4 or 2 bytes an element), the
    larger, summed, plus the pools' and upsamples' bytes."""
    e, peak = (2, PEAK_BF16_FLOPS) if bf16 else (4, PEAK_FP32_FLOPS)
    total = 0.0
    for s, n in train_conv_calls(mode).items():
        nbytes, flops = work("conv3x3_reflect", s[:5], e)
        total += n * max(nbytes / PEAK_BYTES, flops / peak)
    for kernel, calls in train_pool_calls(mode).items():
        total += sum(n * work(kernel, s, e)[0] / PEAK_BYTES for s, n in calls.items())
    return total * 1e3


class _StepProbe:
    """Wraps ``Trainer.train_step`` for a CLI run in process: per step its
    wall time (synchronised) and the clock at its end, its kernel launches
    (counters zeroed around it), its losses; keeps the trainer, the last batch, and the first batch
    with the masters as they were before the first step."""

    def __init__(self, torch, kc, trainer_cls):
        self.torch, self.kc, self.cls = torch, kc, trainer_cls
        self.kernels = kc.KERNELS + kc.BF16_KERNELS
        self.orig = trainer_cls.train_step
        self.steps, self.trainer, self.batch, self.aux_grad = [], None, None, None
        self.first = None

    def __enter__(self):
        probe = self

        def step(trainer, batch):
            torch = probe.torch
            if probe.first is None:
                probe.first = (batch, {n: {k: t.detach().clone() for k, t in leaf.items()}
                                       for n, leaf in trainer.params.items()})
            torch.cuda.synchronize()
            _zero(probe.kc)
            t0 = time.perf_counter()
            losses, rec = probe.orig(trainer, batch)
            torch.cuda.synchronize()
            probe.steps.append({"s": time.perf_counter() - t0, "end": time.perf_counter(),
                                "launches": {k.__name__: k.launches for k in probe.kernels},
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
    """Two more steps of ``trainer`` on ``batch``, the second under
    torch.profiler: its busy device time split into the hand-written
    kernels, cuDNN's backward and the rest, and the device time under each
    backward node (``Conv3x3Backward``, ...); ``totals``: each step's
    weighted loss."""
    from torch.profiler import ProfilerActivity, profile
    total = lambda losses: sum(trainer.loss_weights[k] * float(v) for k, v in losses.items())
    totals = [total(trainer.train_step(batch)[0])]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        totals.append(total(trainer.train_step(batch)[0]))
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
            "top_ms": dict(top.most_common(8)), "backward_nodes_ms": dict(nodes.most_common(8)),
            "totals": totals}


def _loss_falls(torch, trainer, first, steps=8) -> list:
    """The CLI's first batch again from the CLI's own initial masters and a
    fresh Adam state: the weighted loss of ``steps + 1`` steps on it (the
    reference's mixed-precision test takes 1 + 8). The loss falls where the
    lowest of the later ones is below the first: in bf16 the perceptual
    loss moves in steps (the teacher's ``conv0`` maps [0, 1] to about
    +-128, where a bf16 ulp is 0.5, so small changes of the reconstruction
    round away), holding for a few steps, then jumping."""
    batch, params0 = first
    with torch.no_grad():
        for name, leaf in trainer.params.items():
            for kind, t in leaf.items():
                t.copy_(params0[name][kind])
    trainer.opt.state.clear()
    total = lambda losses: sum(trainer.loss_weights[k] * float(v) for k, v in losses.items())
    return [total(trainer.train_step(batch)[0]) for _ in range(steps + 1)]


def _write_training_pngs(torch, c512, s512, folder, n=TRAIN_IMAGES) -> None:
    """``n`` PNG crops of the reflect-tiled photo pair, shorter side 300 to
    420."""
    from collaborative_distillation_tpu_torch.utils.image import save_image
    os.makedirs(folder)
    rng = np.random.default_rng(0)
    tiles = [reflect_tile(torch, c512, 1024), reflect_tile(torch, s512, 1024)]
    for i in range(n):
        h, w = (int(v) for v in rng.integers(300, 421, 2))
        y, x = (int(v) for v in rng.integers(0, 1024 - 420, 2))
        save_image(np.ascontiguousarray(tiles[i % 2][y:y + h, x:x + w]),
                   os.path.join(folder, f"{i:03d}.png"))


def train_cli_runs(torch, kc, c512, s512, tmp, teachers, f32=None) -> dict:
    """8c: ``cli.train`` in process at stage 5 x 16 x 256^2, f32: wct_se and
    wct_sd_kd2sd against phase 9c's teacher store (``teachers``, written by
    ``cli.make_teacher`` on the card), wct_sd --lw_perc 0 on the shipped
    weights alone; each with its launches per step, checkpoint keys, a
    resume, step times, peak memory, one profiled step, and the weighted
    loss falling over 1 + 8 steps on the first batch from the initial
    masters (``_loss_falls``). With ``f32`` (8c's results) the same runs with
    ``--bf16`` (8e): launches on the bf16 kernels only, float32 masters and
    Adam state, and 8c's checkpoint keys."""
    import shutil

    from collaborative_distillation_tpu_torch.cli import train as cli
    from collaborative_distillation_tpu_torch.models.zoo import default_weights_root
    from collaborative_distillation_tpu_torch.train.trainer import Trainer
    bf16 = f32 is not None
    label = "phase 8e" if bf16 else "phase 8c"
    k = TRAIN_STAGE
    shipped = default_weights_root()
    root = os.path.join(tmp, "train_weights")
    data = os.path.join(tmp, "train_images")
    if not bf16:
        shutil.copytree(os.path.join(teachers, "original"), os.path.join(root, "original"))
        shutil.copytree(os.path.join(shipped, "16x_base"), os.path.join(root, "16x_base"))
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
              "--print_interval", "1", "--save_interval", "100"] + (["--bf16"] if bf16 else [])
    out = {}
    cwd = os.getcwd()
    os.chdir(tmp)   # the CLI writes Experiments/ in its working directory
    try:
        for mode, argv in runs.items():
            tag = mode + ("_bf16" if bf16 else "")
            torch.cuda.reset_peak_memory_stats()
            with _StepProbe(torch, kc, Trainer) as probe:
                t0 = time.perf_counter()
                cli.main(argv + common + ["--max_steps", str(TRAIN_STEPS), "-p", tag])
                wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            steps = probe.steps
            want = {**{kk.__name__: 0 for kk in probe.kernels}, **_train_launches(mode, bf16)}
            _check_counts(f"{label}: {tag}, one step", steps[0]["launches"], want)
            for i, st in enumerate(steps):
                if st["launches"] != want:
                    raise AssertionError(f"{label}: {tag} step {i + 1} launches "
                                         f"{st['launches']} != {want}")
                if not all(np.isfinite(v) for v in st["losses"].values()):
                    raise AssertionError(f"{label}: {tag} step {i + 1} losses {st['losses']}")
            (run_dir,) = [d for d in os.listdir("Experiments") if d.endswith("_" + tag)]
            wdir = os.path.join("Experiments", run_dir, "weights")
            (ckpt,) = [os.path.join(wdir, f) for f in os.listdir(wdir) if f.endswith(".npz")]
            with np.load(ckpt) as z:
                keys = set(z.files)
                ckpt_f32 = all(z[kk].dtype == np.float32 for kk in keys
                               if kk.startswith(("params/", "opt_state/0/1", "opt_state/0/2")))
            tr = probe.trainer
            layers = tr.params
            want_keys = ({f"params/{n}/{kk}" for n in layers for kk in ("w", "b")}
                         | {f"opt_state/0/{i}/{n}/{kk}" for i in (1, 2) for n in layers
                            for kk in ("w", "b")}
                         | {"opt_state/0/0", "meta/epoch", "meta/step", "meta/mode",
                            "meta/stage"})
            if keys != want_keys:
                raise AssertionError(f"{label}: {tag} checkpoint keys {sorted(keys ^ want_keys)}")
            if bf16:
                masters = [t for leaf in layers.values() for t in leaf.values()]
                adam = [v for t in masters for v in tr.opt.state[t].values() if v.dim()]
                if not (all(t.dtype == torch.float32 for t in masters + adam) and ckpt_f32
                        and tr.dtype == torch.bfloat16):
                    raise AssertionError(f"{label}: {tag} masters, Adam state or checkpoint "
                                         f"not float32")
                if sorted(keys) != f32[mode]["checkpoint_keys"]:
                    raise AssertionError(f"{label}: {tag} checkpoint keys differ from the "
                                         f"float32 run's")
            prof = _profile_step(torch, tr, probe.batch)
            times = [st["s"] for st in steps[1:]]
            med = statistics.median(times)
            # resume: 48 images at batch 16 are 3 steps an epoch, so the run
            # ended after epoch 2 and the resumed one starts epoch 3
            with _StepProbe(torch, kc, Trainer) as again:
                cli.main(argv + common + ["--max_steps", "1", "--epoch", "3", "--resume", ckpt,
                                          "-p", tag + "_resumed"])
            (rdir,) = [d for d in os.listdir("Experiments") if d.endswith(tag + "_resumed")]
            rlog = open(os.path.join("Experiments", rdir, "weights", [
                f for f in os.listdir(os.path.join("Experiments", rdir, "weights"))
                if f.startswith("log_")][0])).read()
            if "at epoch 2" not in rlog or "E3S0" not in rlog or len(again.steps) != 1:
                raise AssertionError(f"{label}: {tag} --resume did not continue at epoch 3")
            if bf16 and ("compute bfloat16" not in rlog
                         or again.steps[0]["launches"] != want):
                raise AssertionError(f"{label}: {tag} --resume did not train in bf16")
            prof["kernels_bound_ms"] = _train_kernel_bound_ms(mode, bf16)
            totals = _loss_falls(torch, tr, probe.first)
            if not (all(np.isfinite(totals)) and min(totals[1:]) < totals[0]):
                raise AssertionError(f"{label}: {tag}: the loss on the first batch did not fall "
                                     f"over 1 + 8 steps from the initial masters: {totals}")
            out[mode] = {"steps_s": [st["s"] for st in steps], "median_s": med,
                         "images_per_s": TRAIN_N / med, "peak_gib": peak, "wall_s": wall,
                         "launches_per_step": want, "losses_first": steps[0]["losses"],
                         "losses_last": steps[-1]["losses"], "aux_grad_max": probe.aux_grad,
                         "profile": prof, "resumed_losses": again.steps[0]["losses"],
                         "checkpoint_keys": sorted(keys), "first_batch_totals": totals}
            vs = ""
            if bf16:
                r32 = f32[mode]
                vs = (f" (float32 {r32['median_s'] * 1e3:.1f} ms, {r32['images_per_s']:.2f} "
                      f"images/s, peak {r32['peak_gib']:.2f} GiB: bf16 {r32['median_s'] / med:.2f}x "
                      f"the step rate)")
            log(f"{label}: cli.train {tag} stage {k} x {TRAIN_N} x {TRAIN_HW}^2: "
                f"{len(steps)} steps, median step {med * 1e3:.1f} ms over steps 2-{len(steps)} "
                f"({TRAIN_N / med:.2f} images/s; steps {', '.join(f'{t * 1e3:.0f}' for t in times)} "
                f"ms), peak {peak:.2f} GiB{vs}, wall {wall:.1f} s; losses first "
                f"{steps[0]['losses']}, last {steps[-1]['losses']}; the first batch's weighted "
                f"loss over 1 + 8 steps from the initial masters "
                f"{', '.join(f'{t:.6g}' for t in totals)}; checkpoint keys in the reference's "
                f"layout ({len(keys)}); --resume continued at epoch 3")
            if not prof["busy_ms"]:
                log(f"{label}: {tag}: the profiler saw no device time: split not measured")
            log(f"{label}: {tag} profiled step: busy {prof['busy_ms']:.1f} ms = hand-written "
                f"kernels {prof['kernels_ms']:.1f} (bound {prof['kernels_bound_ms']:.1f}) + cuDNN "
                f"backward convs {prof['cudnn_backward_ms']:.1f} + cuBLAS GEMMs "
                f"{prof['gemm_ms']:.1f} + rest {prof['rest_ms']:.1f}; backward nodes: " + "; ".join(
                    f"{n} {ms:.1f}" for n, ms in prof["backward_nodes_ms"].items())
                + "; top kernels: " + "; ".join(
                    f"{n} {ms:.1f}" for n, ms in prof["top_ms"].items()))
        aux = out["wct_sd_kd2sd"]["aux_grad_max"]
        log(f"{label}: wct_sd_kd2sd --updim_relu from zero-filled aux adapters: first-step "
            f"max|grad w| {aux}")
        if not aux or not all(v > 0 for v in aux.values()):
            raise AssertionError(f"{label}: zero aux adapters got no gradient {aux}")
    finally:
        os.chdir(cwd)
    return out


def teacher_conv_times(torch) -> dict:
    """8d: conv3x3_reflect at every conv shape of a wct_se step (stage 5 x
    16 x 256^2) at the teachers' widths (Cin or Cout 256/512), forward only,
    against its plain version and cuDNN's FP32 forward (a reflect
    ``nn.Conv2d``, TF32 off), summed over the step's calls beside the bound;
    ``first_launches``: the step's convs, of every width, that plan the
    first kernel."""
    from collaborative_distillation_tpu_torch.ops.cuda.conv import device_plan
    step = train_conv_calls("wct_se")
    bench = Bench(torch, None)
    rows = []
    for s, n in sorted(step.items()):
        if teacher_width(s):
            rows.append({**bench.run("conv3x3_reflect", s, timed=True), "calls": n,
                         "plan": device_plan(*s[:5], 0).kernel})
    out = {"launches": sum(r["calls"] for r in rows), **path_times(rows), "shapes": rows,
           "first_launches": sum(n for s, n in step.items()
                                 if device_plan(*s[:5], 0).kernel == "first")}
    by_plan = Counter()
    for r in rows:
        by_plan[r["plan"]] += r["calls"]
    log(f"phase 8d: a wct_se step's {out['launches']} teacher-width convs (N = {TRAIN_N}; "
        f"plans {dict(by_plan)}): {out['ms']:.2f} ms, {out['bound_ms'] / out['ms']:.1%} of "
        f"the bound {out['bound_ms']:.2f} ({out['bound_by']}); cuDNN FP32 (TF32 off) "
        f"{out['library_ms']:.2f}, plain {out['plain_ms']:.2f}; the step's convs on the "
        f"first kernel: {out['first_launches']}")
    return out


def _bf16_grad_bounds(torch, got, want, scale) -> list:
    """The largest ratio of |got - want| to its bound (BF16_GRAD in the
    tolerances above) for each of a bf16 conv's dx, dw, db."""
    worst = []
    for i, (a, r, sc) in enumerate(zip(got, want, scale)):
        if a.dtype != torch.bfloat16:
            raise AssertionError(f"conv3x3 bf16 gradient {'xwb'[i]} is {a.dtype}")
        a, r = a.float(), r.float()
        bound = ((r.abs() + sc) * BF16_ULP if i == 0
                 else r.abs() * BF16_ULP + CONV_TOL * float(sc.abs().max()))
        worst.append(float(((a - r).abs() / bound.clamp_min(1e-30)).max()))
    return worst


def train_bf16_autograd_checks(torch) -> dict:
    """8e(a): the Functions in bf16 against the plain versions' autograd on
    the card at every conv, pool and upsample shape of the three bf16 steps
    (stage 5, N = 16, 256^2 -> 16^2, teacher widths included): the forward
    within one bf16 ulp (phase 10a's rule), the conv's gradients within
    BF16_GRAD under the Function's ReLU decisions, the pool's (ties: the
    first maximum) and the upsample's (2x2 sums rounded once) exact."""
    from collaborative_distillation_tpu_torch.ops import conv as tconv
    from collaborative_distillation_tpu_torch.ops.cuda import conv as kconv
    from collaborative_distillation_tpu_torch.ops.cuda import pool as kpool
    from collaborative_distillation_tpu_torch.ops.precision import full_float32
    F = torch.nn.functional
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(9)
    rand = lambda *s: torch.rand(s, generator=gen, device="cuda")
    convs, pools, ups = set(), set(), set()
    for mode in ("wct_se", "wct_sd", "wct_sd_kd2sd"):
        convs |= set(train_conv_calls(mode))
        calls = train_pool_calls(mode)
        pools |= set(calls["max_pool_2x2"])
        ups |= set(calls["upsample_nearest_2x"])
    worst_fwd, worst = 0.0, [0.0, 0.0, 0.0]
    with full_float32():
        for n, h, w, ci, co, relu in sorted(convs):
            x = rand(n, h, w, ci).to(bf).requires_grad_()
            wt = ((rand(3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)).to(bf).requires_grad_()
            b = (rand(co) - 0.5).to(bf).requires_grad_()
            g = (rand(n, h, w, co) - 0.5).to(bf)
            y = tconv.conv3x3(x, wt, b, relu=relu)
            got = torch.autograd.grad(y, (x, wt, b), g)
            with torch.no_grad():
                pre = kconv.conv3x3_reflect(x, wt, b, False)
                plain = kconv.conv3x3_plain(x, wt, b, False)
                for a, r in ((y, plain.clamp_min(0) if relu else plain), (pre, plain)):
                    r32 = r.float()
                    bound = torch.clamp(r32.abs() * BF16_ULP,
                                        min=BF16_FLOOR * float(r32.abs().max()))
                    err = (a.float() - r32).abs()
                    if a.dtype != bf or bool((err > bound).any()):
                        raise AssertionError(f"conv3x3 bf16 forward at {(n, h, w, ci, co, relu)}:"
                                             f" {int((err > bound).sum())} outputs past one ulp")
                    worst_fwd = max(worst_fwd, float((err / bound).max()))
                gp = (g * (pre > 0).to(bf).masked_fill_(pre == 0, 0.5)) if relu else g
                del pre, plain
            want = torch.autograd.grad(kconv.conv3x3_plain(x, wt, b, False), (x, wt, b), gp)
            ab = [t.detach().float().abs().requires_grad_() for t in (x, wt, b)]
            scale = torch.autograd.grad(kconv.conv3x3_plain(*ab, False), ab, gp.float().abs())
            ratio = _bf16_grad_bounds(torch, got, want, scale)
            if not max(ratio) <= 1:
                raise AssertionError(f"conv3x3 bf16 gradients at {(n, h, w, ci, co, relu)}: "
                                     f"dx, dw, db at {ratio} of the bound")
            worst = [max(a, r) for a, r in zip(worst, ratio)]
            del x, wt, b, g, gp, y, got, want, ab, scale
        for shape in sorted(pools):
            x = torch.floor(rand(*shape) * 3).to(bf).requires_grad_()
            y = tconv.max_pool_2x2(x)
            g = (rand(*y.shape) - 0.5).to(bf)
            got = torch.autograd.grad(y, x, g)[0]
            want = torch.autograd.grad(F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(
                0, 2, 3, 1), x, g)[0]
            if not (got.dtype == bf and torch.equal(got, want)
                    and torch.equal(y, kpool.max_pool_2x2_plain(x.detach()))):
                raise AssertionError(f"max_pool_2x2 bf16 at {shape}: forward or gradient")
        for shape in sorted(ups):
            n, h, w, c = shape
            x = (rand(*shape) - 0.5).to(bf).requires_grad_()
            g = (rand(n, 2 * h, 2 * w, c) - 0.5).to(bf)
            y = tconv.upsample_nearest_2x(x)
            got = torch.autograd.grad(y, x, g)[0]
            want = g.float().reshape(n, h, 2, w, 2, c).sum(dim=(2, 4)).to(bf)
            if not (got.dtype == bf and torch.equal(got, want)
                    and torch.equal(y, kpool.upsample_nearest_2x_plain(x.detach()))):
                raise AssertionError(f"upsample_nearest_2x bf16 at {shape}: forward or gradient")
    out = {"conv_shapes": len(convs), "pool_shapes": len(pools), "upsample_shapes": len(ups),
           "forward_worst_of_ulp": worst_fwd, "grad_worst_of_bound": worst}
    log(f"phase 8e(a): bf16 Functions vs the plain versions' autograd at the three bf16 "
        f"steps' {len(convs)} conv3x3 shapes (N = {TRAIN_N}, Cin/Cout 3-512): forward at most "
        f"{worst_fwd:.3f} of one bf16 ulp, gradients dx / dw / db at most "
        f"{' / '.join(f'{r:.3f}' for r in worst)} of BF16_GRAD (dw, db: "
        f"2^-7 |ref| + {CONV_TOL} x largest partial sum; dx: 2^-7 (|ref| + partial sum)); "
        f"{len(pools)} pool and {len(ups)} upsample shapes exact, forward and gradient")
    return out


def train_bf16_card_vs_cpu(torch) -> dict:
    """8e(b): one bf16 step of each mode on the card against the same step on
    the CPU (stage 2, N = 2, 64^2, seeded weights and batch): losses within
    BF16_LOSS_REL, each student leaf's gradient within BF16_STEP_REL in
    relative L2 norm, masters and gradients float32."""
    out = {}
    for mode in ("wct_se", "wct_sd", "wct_sd_kd2sd"):
        _, card, cpu, batch = _card_and_cpu(torch, mode, "bfloat16")
        lc, rc = card.train_step(batch)
        lp, _ = cpu.train_step(batch)
        loss_err = max(abs(float(lc[k]) - float(lp[k])) / abs(float(lp[k])) for k in lp)
        grad_err = 0.0
        f32 = rc.dtype == torch.float32
        for name, leaf in cpu.params.items():
            for kind, t in leaf.items():
                gc = card.params[name][kind].grad
                f32 &= gc.dtype == card.params[name][kind].dtype == torch.float32
                gc = gc.cpu().double()
                grad_err = max(grad_err, float((gc - t.grad.double()).norm())
                               / max(float(t.grad.double().norm()), 1e-300))
        out[mode] = {"loss_rel_err": loss_err, "grad_rel_l2": grad_err, "float32": f32}
        if not (loss_err <= BF16_LOSS_REL and grad_err <= BF16_STEP_REL and f32):
            raise AssertionError(f"phase 8e(b) {mode}: card vs cpu {out[mode]}")
    log(f"phase 8e(b): one bf16 step card vs cpu (stage 2, N=2, 64^2): " + "; ".join(
        f"{m} losses {r['loss_rel_err']:.2e} rel, student grads {r['grad_rel_l2']:.2e} "
        f"(relative L2, worst leaf)" for m, r in out.items())
        + f" (tol {BF16_LOSS_REL}, {BF16_STEP_REL}); masters, gradients and rec float32")
    return out


def train_bf16_kernel_times(torch) -> dict:
    """8e(d): the bf16 kernels at every conv, pool and upsample shape of the
    three bf16 steps, each checked against its plain version (phase 10a's
    rule) and timed beside it, the library call and the bound at 2-byte
    elements and the bf16 peak; summed per mode over a step's calls
    (``path_times``). Returns {kernel: {mode: sums}}."""
    bench = Bench(torch, None)
    rows = {}
    out = {k: {} for k in ("conv3x3_reflect_bf16", "max_pool_2x2_bf16",
                           "upsample_nearest_2x_bf16")}
    for mode in ("wct_se", "wct_sd", "wct_sd_kd2sd"):
        calls = {"conv3x3_reflect": train_conv_calls(mode), **train_pool_calls(mode)}
        for kernel, shapes in calls.items():
            mine = []
            for shape, n in sorted(shapes.items()):
                key = (kernel, shape)
                if key not in rows:
                    rows[key] = bench.run(BF16_OF[kernel], shape, timed=True)
                mine.append({**rows[key], "calls": n})
            out[BF16_OF[kernel]][mode] = {"launches": sum(r["calls"] for r in mine),
                                          **path_times(mine)}
    out["shapes"] = [{**r, "kernel": k[0]} for k, r in rows.items()]
    for name in ("conv3x3_reflect_bf16", "max_pool_2x2_bf16", "upsample_nearest_2x_bf16"):
        log(f"phase 8e(d): {name} per bf16 step: " + "; ".join(
            f"{m} {r['ms']:.3f} ms over {r['launches']} launches (plain {r['plain_ms']:.3f}, "
            f"library {r['library_ms']:.3f}, bound {r['bound_ms']:.3f} {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of it)" for m, r in out[name].items()))
    return out


def training_bf16(torch, kc, c512, s512, tmp, teachers, f32) -> dict:
    """Phase 8e: bf16 mixed-precision training, with its own clock; ``f32``:
    phase 8c's runs, printed beside the bf16 ones."""
    t0 = time.perf_counter()
    out = {"autograd": train_bf16_autograd_checks(torch),
           "card_vs_cpu": train_bf16_card_vs_cpu(torch),
           "cli": train_cli_runs(torch, kc, c512, s512, tmp, teachers, f32=f32),
           "kernel_times": train_bf16_kernel_times(torch)}
    for mode, r in out["cli"].items():
        p, p32 = r["profile"], f32[mode]["profile"]
        log(f"phase 8e: {mode} bf16 vs float32 step: median {r['median_s'] * 1e3:.1f} vs "
            f"{f32[mode]['median_s'] * 1e3:.1f} ms, {r['images_per_s']:.2f} vs "
            f"{f32[mode]['images_per_s']:.2f} images/s, peak {r['peak_gib']:.2f} vs "
            f"{f32[mode]['peak_gib']:.2f} GiB; profiled busy {p['busy_ms']:.1f} vs "
            f"{p32['busy_ms']:.1f} ms: hand-written kernels {p['kernels_ms']:.1f} vs "
            f"{p32['kernels_ms']:.1f}, cuDNN backward {p['cudnn_backward_ms']:.1f} vs "
            f"{p32['cudnn_backward_ms']:.1f}, cuBLAS {p['gemm_ms']:.1f} vs {p32['gemm_ms']:.1f}, "
            f"rest {p['rest_ms']:.1f} vs {p32['rest_ms']:.1f}")
    out["phase8e_s"] = time.perf_counter() - t0
    log(f"phase 8e: {out['phase8e_s']:.1f} s")
    return out


# ---- phase 8f: data-parallel training -------------------------------------------

DP_REPLICAS = 4      # replicas of phase 8f, all on cuda:0
DP_CHECKED = 3       # steps held to the single-device step from the same state
DP_SEED = 5


def dp_setup(torch, c512, s512) -> tuple:
    """Phase 8f's wct_se at stage 5 x 16 x 256^2: (student, frozen, batches):
    the teachers and the 16x student drawn from a seeded ``torch.Generator``
    on the CPU, and DP_CHECKED uint8 batches of TRAIN_N 256^2 crops of the
    reflect-tiled photo pair from a seeded generator (any process draws the
    same)."""
    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    from collaborative_distillation_tpu_torch.models.vgg import init_params
    gen = torch.Generator().manual_seed(DP_SEED)
    frozen = {"be": init_params(encoder_spec("original", TRAIN_STAGE), gen),
              "bd": init_params(decoder_spec("original", TRAIN_STAGE), gen)}
    student = init_params(encoder_spec("16x", TRAIN_STAGE, aux=True), gen)
    rng = np.random.default_rng(DP_SEED)
    tiles = [reflect_tile(torch, c512, 1024), reflect_tile(torch, s512, 1024)]
    batches = []
    for _ in range(DP_CHECKED):
        crops = []
        for i in range(TRAIN_N):
            y, x = (int(v) for v in rng.integers(0, 1024 - TRAIN_HW, 2))
            crops.append(tiles[i % 2][y:y + TRAIN_HW, x:x + TRAIN_HW])
        batches.append(np.stack(crops))
    return student, frozen, batches


def _dp_state(trainer) -> tuple:
    """The root masters and Adam state, copied."""
    import copy
    return ({n: {k: t.detach().clone() for k, t in leaf.items()}
             for n, leaf in trainer.params.items()}, copy.deepcopy(trainer.opt.state_dict()))


def _dp_load(torch, trainer, state) -> None:
    import copy
    masters, opt = state
    with torch.no_grad():
        for n, leaf in trainer.params.items():
            for k, t in leaf.items():
                t.copy_(masters[n][k])
    trainer.opt.load_state_dict(copy.deepcopy(opt))


def _dp_steps(torch, kc, trainer, batches, steps, devices, before=None) -> dict:
    """``steps`` steps of ``trainer`` on ``batches`` in turn, the counters
    zeroed just before each and read just after: each step's wall
    (synchronised) and host enqueue (until ``train_step`` returns), launches
    and losses; for the first DP_CHECKED the root's gradient, ``before(i)``
    (untimed) run before step i, and whether every replica's masters equal
    the root's bit for bit; the peak memory of each card used."""
    cards = sorted({torch.device(d).index or 0 for d in devices})
    torch.cuda.synchronize()
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    out = []
    for i in range(steps):
        if before is not None:
            before(i)
        for c in cards:
            torch.cuda.synchronize(c)
        _zero(kc)
        t0 = time.perf_counter()
        losses, rec = trainer.train_step(batches[i % len(batches)])
        t1 = time.perf_counter()
        for c in cards:
            torch.cuda.synchronize(c)
        t2 = time.perf_counter()
        st = {"s": t2 - t0, "enqueue_s": t1 - t0,
              "launches": {k.__name__: k.launches for k in kc.KERNELS + kc.BF16_KERNELS},
              "losses": {k: float(v) for k, v in losses.items()},
              "rec_ok": tuple(rec.shape) == (TRAIN_N, TRAIN_HW, TRAIN_HW, 3)
              and rec.dtype == torch.float32 and bool(torch.isfinite(rec).all())}
        if i < DP_CHECKED:
            st["grads"] = {n: {k: t.grad.detach().clone() for k, t in leaf.items()}
                           for n, leaf in trainer.params.items()}
            root = [t for leaf in trainer.params.values() for t in leaf.values()]
            st["replicas_equal"] = all(
                torch.equal(t, r.to(t.device)) for rep in trainer.replicas[1:]
                for t, r in zip([t for leaf in rep.params().values() for t in leaf.values()],
                                root))
        out.append(st)
    times = [st["s"] for st in out[1:]]
    return {"steps": out, "median_s": statistics.median(times),
            "enqueue_median_s": statistics.median(st["enqueue_s"] for st in out[1:]),
            "peak_gib": {f"cuda:{c}": torch.cuda.max_memory_allocated(c) / 2 ** 30
                         for c in cards}}


def _dp_errors(torch, got, want, bf16) -> dict:
    """Losses' relative error and the worst leaf's gradient error: of max|g|
    in float32, relative L2 in bf16 (8e(b)'s measures)."""
    loss = max(abs(got["losses"][k] - want["losses"][k]) / abs(want["losses"][k])
               for k in want["losses"])
    grad = 0.0
    for n, leaf in want["grads"].items():
        for k, g in leaf.items():
            d = got["grads"][n][k].double() - g.double()
            grad = max(grad, float(d.norm() / g.double().norm()) if bf16
                       else float(d.abs().max() / g.abs().max()))
    return {"loss_rel_err": loss, "grad_err": grad}


def dp_compare(torch, kc, setup, dtype: str, devices, label, steps=TRAIN_STEPS) -> dict:
    """A data-parallel ``Trainer`` on ``make_mesh(data=len(devices),
    devices=devices)`` against a single-device one on ``cuda:0``, wct_se,
    both from ``setup``'s weights: ``steps`` steps each on its batches in
    turn. Before each of the first DP_CHECKED single-device steps the
    single-device trainer takes the data-parallel one's masters and Adam
    state from before the same step, so both differentiate at the same
    masters (Adam near 0 may step either way between two reduction orders):
    losses within 1e-5 relative and the root's mean gradient within 1e-4
    of each leaf's max|g| in float32, BF16_LOSS_REL and BF16_STEP_REL
    (relative L2) in bf16; every replica's masters bit-identical to the
    root's; launches len(devices) x the single step's (``_train_launches``),
    losses finite, ``rec`` the whole batch's. Returns both runs' step
    medians (steps 2..``steps``), images/s, host enqueue, peaks and the
    errors; raises on a failed check."""
    import gc

    from collaborative_distillation_tpu_torch.parallel.mesh import make_mesh
    from collaborative_distillation_tpu_torch.train.trainer import TrainConfig, Trainer
    student, frozen, batches = setup
    bf16 = dtype == "bfloat16"
    cfg = TrainConfig(mode="wct_se", stage=TRAIN_STAGE, batch_size=TRAIN_N, compute_dtype=dtype)
    per_step = _train_launches("wct_se", bf16)
    zero = {k.__name__: 0 for k in kc.KERNELS + kc.BF16_KERNELS}
    dp = Trainer(cfg, student, frozen, mesh=make_mesh(data=len(devices), devices=devices))
    states = []
    run = _dp_steps(torch, kc, dp, batches, steps, devices,
                    before=lambda i: states.append(_dp_state(dp)) if i < DP_CHECKED else None)
    del dp
    gc.collect()
    torch.cuda.empty_cache()
    one = Trainer(cfg, student, frozen, device="cuda:0")
    ref = _dp_steps(torch, kc, one, batches, steps, ["cuda:0"],
                    before=lambda i: _dp_load(torch, one, states[i]) if i < DP_CHECKED else None)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    errs = [_dp_errors(torch, run["steps"][i], ref["steps"][i], bf16) for i in range(DP_CHECKED)]
    loss_tol, grad_tol = (BF16_LOSS_REL, BF16_STEP_REL) if bf16 else (1e-5, 1e-4)
    want_dp = {**zero, **{k: len(devices) * v for k, v in per_step.items()}}
    want_one = {**zero, **per_step}
    bad = [f"step {i + 1}: {e}" for i, e in enumerate(errs)
           if not (e["loss_rel_err"] <= loss_tol and e["grad_err"] <= grad_tol)]
    bad += [f"step {i + 1}: replicas differ from the root" for i, st in
            enumerate(run["steps"][:DP_CHECKED]) if not st["replicas_equal"]]
    bad += [f"{who} step {i + 1}: launches {st['launches']} != {want}"
            for who, r, want in (("DP", run, want_dp), ("single", ref, want_one))
            for i, st in enumerate(r["steps"]) if st["launches"] != want]
    bad += [f"{who} step {i + 1}: losses {st['losses']} or rec not finite/whole"
            for who, r in (("DP", run), ("single", ref)) for i, st in enumerate(r["steps"])
            if not (st["rec_ok"] and all(np.isfinite(v) for v in st["losses"].values()))]
    if bad:
        raise AssertionError(f"{label} {dtype}: " + "; ".join(bad))
    out = {"devices": [str(d) for d in devices], "dtype": dtype, "errors": errs,
           "launches_per_step": want_dp, "single_launches_per_step": want_one,
           **{f"{k}": run[k] for k in ("median_s", "enqueue_median_s", "peak_gib")},
           "images_per_s": TRAIN_N / run["median_s"],
           "steps_s": [st["s"] for st in run["steps"]],
           "single": {"median_s": ref["median_s"], "images_per_s": TRAIN_N / ref["median_s"],
                      "enqueue_median_s": ref["enqueue_median_s"], "peak_gib": ref["peak_gib"],
                      "steps_s": [st["s"] for st in ref["steps"]]},
           "losses_first": run["steps"][0]["losses"], "losses_last": run["steps"][-1]["losses"]}
    worst = {k: max(e[k] for e in errs) for k in ("loss_rel_err", "grad_err")}
    log(f"{label}: wct_se {dtype} stage {TRAIN_STAGE} x {TRAIN_N} x {TRAIN_HW}^2 on "
        f"{len(devices)} replicas ({', '.join(out['devices'])}; {TRAIN_N // len(devices)} images "
        f"each) vs one device: median step {run['median_s'] * 1e3:.1f} vs "
        f"{ref['median_s'] * 1e3:.1f} ms over steps 2-{steps} ({out['images_per_s']:.2f} vs "
        f"{out['single']['images_per_s']:.2f} images/s), host enqueue "
        f"{run['enqueue_median_s'] * 1e3:.1f} vs {ref['enqueue_median_s'] * 1e3:.1f} ms, peak "
        + ", ".join(f"{d} {g:.2f}" for d, g in run["peak_gib"].items()) + " vs "
        + ", ".join(f"{g:.2f}" for g in ref["peak_gib"].values())
        + f" GiB; launches a step {dict((k, v) for k, v in want_dp.items() if v)} "
        f"({len(devices)} x the single step's); over {DP_CHECKED} steps from the same state: "
        f"losses {worst['loss_rel_err']:.2e} rel (tol {loss_tol:.3g}), root gradient "
        f"{worst['grad_err']:.2e} {'rel L2' if bf16 else 'of max|g|'} (tol {grad_tol:.3g}), "
        f"replicas bit-identical to the root")
    return out


def train_data_parallel(torch, kc, c512, s512) -> dict:
    """8f: four replicas on cuda:0 against one device, float32 and bf16
    (:func:`dp_compare`), with its own clock."""
    t0 = time.perf_counter()
    setup = dp_setup(torch, c512, s512)
    out = {dtype: dp_compare(torch, kc, setup, dtype, ["cuda:0"] * DP_REPLICAS, "phase 8f")
           for dtype in ("float32", "bfloat16")}
    out["phase8f_s"] = time.perf_counter() - t0
    log(f"phase 8f: {out['phase8f_s']:.1f} s")
    return out


# ---- phase 8g: JPEG training folders decoded on the card -------------------------

# the folder's (count, H, W): COCO's usual 480 x 640 (denom 1 at shorter side
# 300), then sizes the reference reads at denom 2, 4 and 8; every other file
# portrait. Edge files: a size no denom divides (1301 x 1703, denom 4) and a
# shorter side under 300 (an upscale).
JPEG_TRAIN_MIX = ((24, 480, 640), (12, 700, 1000), (8, 1300, 1700), (4, 2500, 3300))
JPEG_TRAIN_EDGE = ((1301, 1703), (257, 383))
JPEG_TRAIN_SIDE = 300          # cli.train's default --shorter_side
JPEG_TRAIN_STEPS = 8           # images/s: the median of steps 2-8
JPEG_TRAIN_FIXTURE = ("d1", "d2", "d4", "d8", "c444", "prog", "up", "coco")
DATA_META = {
    "scale_reduce_u8": ("jpeg_resize.cu",
                        "not a TPU kernel; counterpart of native/imgcodec.cpp:67 (cd_jpeg_decode "
                        "at 1/scale_denom, libjpeg's scaled IDCT)"),
    "box_resize_u8": ("jpeg_resize.cu",
                      "not a TPU kernel; counterpart of native/imgcodec.cpp:441 (cd_resize_rgb)"),
}


def jpeg_train_sizes(n: int) -> list:
    """(H, W) of ``n`` training JPEGs in JPEG_TRAIN_MIX's proportions (its
    48 sizes over and over), every other one portrait."""
    mix = [(h, w) for count, h, w in JPEG_TRAIN_MIX for _ in range(count)]
    return [(w, h) if i % 2 else (h, w) for i, (h, w) in
            enumerate(mix[i % len(mix)] for i in range(n))]


def write_training_jpegs(torch, c512, s512, folder, sizes) -> dict:
    """JPEGs of the photo pair reflect-tiled on the card to ``sizes``
    (content and style in turns, offset crops), encoded there by nvJPEG at
    quality 95; returns {path: (H, W)}."""
    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    from collaborative_distillation_tpu_torch.ops.pad import reflect_index
    os.makedirs(folder)
    photos = [torch.from_numpy(a).cuda() for a in (c512, s512)]
    out = {}
    for i, (h, w) in enumerate(sizes):
        x, off = photos[(i // 2) % 2], (37 * i) % 200
        rows = reflect_index(x.shape[0], -off, off + h - x.shape[0], x.device)
        cols = reflect_index(x.shape[1], -off, off + w - x.shape[1], x.device)
        body = nj.encode_jpeg(x.index_select(0, rows).index_select(1, cols).contiguous(),
                              quality=95)
        if body is None:
            raise AssertionError(f"phase 8g: nvJPEG did not encode {h}x{w}")
        path = os.path.join(folder, f"{i:03d}.jpg")
        with open(path, "wb") as f:
            f.write(body)
        out[path] = (h, w)
    return out


def _chain_launches(sizes) -> dict:
    """The resize kernels' launches for decoding files of ``sizes``: the
    block mean where denom is over 1, the box resize where the size
    changes."""
    from collaborative_distillation_tpu_torch.data.jpeg import shorter_side_plan
    plans = [shorter_side_plan(h, w, JPEG_TRAIN_SIDE) for h, w in sizes]
    return {"scale_reduce_u8": sum(d > 1 for d, _, _ in plans),
            "box_resize_u8": sum(scaled != size for _, scaled, size in plans)}


def _u8_work(kernel, shape) -> tuple:
    """(bytes, integer adds) of one resize: each input byte read once, each
    output byte written once; the block mean adds d * d bytes for each
    output byte, the box resize its window's."""
    if kernel == "scale_reduce_u8":
        h, w, d = shape
        out = 3 * -(-h // d) * -(-w // d)
        return 3 * h * w + out, out * d * d
    sh, sw, dh, dw = shape
    rows = [max((y + 1) * sh // dh, y * sh // dh + 1) - y * sh // dh for y in range(dh)]
    cols = [max((x + 1) * sw // dw, x * sw // dw + 1) - x * sw // dw for x in range(dw)]
    return 3 * (sh * sw + dh * dw), 3 * sum(rows) * sum(cols)


def jpeg_kernel_checks(torch, kc, files) -> dict:
    """8g: each resize kernel bit-equal to its plain version on nvJPEG's
    decode of every file (the shapes the loader gives it) and at edge shapes
    (1-pixel outputs, widths not a multiple of 4 or of denom, upscales);
    then each timed at every distinct shape of the folder (queued, L2
    flushed: the host's pace taken out) beside its plain version, its
    library yardstick (``F.avg_pool2d(ceil_mode=True)``,
    ``F.interpolate(mode="area")`` on the same image as float32 NCHW, made
    outside the timed call; not bit-equal) and its byte bound, and summed
    per training batch: ``TRAIN_N`` of the folder's files, the folder's mix."""
    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    from collaborative_distillation_tpu_torch.data.jpeg import shorter_side_plan
    F = torch.nn.functional
    worst = {k.__name__: 0 for k in kc.DATA_KERNELS}
    shapes = {k.__name__: Counter() for k in kc.DATA_KERNELS}
    n_checks = 0

    def check(kernel, x, *args):
        nonlocal n_checks
        fn = getattr(kc, kernel)
        got, want = fn(x, *args), fn.plain(x, *args)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max()) if got.shape == want.shape else 256
        worst[kernel] = max(worst[kernel], err)
        n_checks += 1
        if err:
            raise AssertionError(f"phase 8g: {kernel}{tuple(x.shape)}{args} differs from its "
                                 f"plain version by {err} levels")
        return got

    decoded = {}
    for path, (h, w) in files.items():
        with open(path, "rb") as f:
            x = nj.decode_jpeg(f.read())
        if x is None or tuple(x.shape) != (h, w, 3):
            raise AssertionError(f"phase 8g: nvJPEG decode of {path}: "
                                 f"{None if x is None else tuple(x.shape)}")
        denom, scaled, (dh, dw) = shorter_side_plan(h, w, JPEG_TRAIN_SIDE)
        if denom > 1:
            shapes["scale_reduce_u8"][(h, w, denom)] += 1
            decoded.setdefault((h, w, denom), x)
            x = check("scale_reduce_u8", x, denom)
        if scaled != (dh, dw):
            shapes["box_resize_u8"][(*scaled, dh, dw)] += 1
            decoded.setdefault((*scaled, dh, dw), x)
            check("box_resize_u8", x, dw, dh)
    gen = torch.Generator(device="cuda").manual_seed(8)
    u8 = lambda h, w: (torch.rand((h, w, 3), generator=gen, device="cuda") * 256).to(torch.uint8)
    for h, w in ((1, 1), (1, 7), (5, 1), (9, 13), (17, 30), (333, 451)):
        for d in (1, 2, 4, 8):
            check("scale_reduce_u8", u8(h, w), d)
    for sh, sw, dh, dw in ((1, 1, 1, 1), (1, 1, 5, 3), (7, 9, 1, 1), (10, 13, 3, 5),
                           (5, 5, 9, 11), (17, 31, 16, 1), (326, 426, 300, 392),
                           (257, 383, 300, 447)):
        check("box_resize_u8", u8(sh, sw), dw, dh)
    per_batch = TRAIN_N / len(files)
    rows = {}
    for kernel, counts in shapes.items():
        fn, timed = getattr(kc, kernel), []
        for shape, n in sorted(counts.items()):
            x = decoded[shape]
            xf = x.permute(2, 0, 1)[None].float().contiguous()
            if kernel == "scale_reduce_u8":
                args, lib = (shape[2],), lambda: F.avg_pool2d(xf, shape[2], ceil_mode=True)
            else:
                args, lib = (shape[3], shape[2]), lambda: F.interpolate(
                    xf, size=shape[2:], mode="area")
            nbytes, adds = _u8_work(kernel, shape)
            r = {"shape": shape, "files": n, "ms": queued_ms(torch, lambda: fn(x, *args), 10),
                 "plain_ms": queued_ms(torch, lambda: fn.plain(x, *args), 10),
                 "library_ms": queued_ms(torch, lib, 10),
                 "bytes_ms": nbytes / PEAK_BYTES * 1e3,
                 # integer adds: 64 INT32 lanes an SM against 128 FP32 ones,
                 # whose FMA the FP32 peak counts as two operations
                 "flops_ms": adds / (PEAK_FP32_FLOPS / 4) * 1e3, "calls": n * per_batch}
            timed.append(r)
            log(f"phase 8g: {kernel} {shape} x{n} files: {r['ms'] * 1e3:.1f} us, plain "
                f"{r['plain_ms'] * 1e3:.1f} us, library {r['library_ms'] * 1e3:.1f} us, bound "
                f"{max(r['bytes_ms'], r['flops_ms']) * 1e3:.2f} us")
        rows[kernel] = {"max_abs_err": worst[kernel], "per_batch": path_times(timed),
                        "shapes": timed}
    log(f"phase 8g: {n_checks} kernel-vs-plain checks bit-equal (every file's decode of "
        f"{len(files)}, edge shapes); max level difference {worst}")
    return {"checks": n_checks, "rows": rows}


def jpeg_fixture_chain(torch) -> dict:
    """8g: the card's chain (nvJPEG, then the kernels) on the training
    fixture's files against the reference's libjpeg scaled decodes in
    ``data/jpeg_train_fixture.npz``, at PSNR_MIN_DB."""
    from collaborative_distillation_tpu_torch.data import jpeg
    out = {}
    with np.load(os.path.join(HERE, "collaborative_distillation_tpu_torch", "data",
                              "jpeg_train_fixture.npz")) as d:
        for name in JPEG_TRAIN_FIXTURE:
            got = jpeg.decode_jpeg_shorter_side(d[f"{name}_jpeg"].tobytes(),
                                                int(d[f"{name}_side"]), "cuda")
            want = d[f"{name}_out"]
            if got is None or tuple(got.shape) != want.shape:
                raise AssertionError(f"phase 8g: fixture {name}: "
                                     f"{None if got is None else tuple(got.shape)} "
                                     f"!= {want.shape}")
            got = got.cpu().numpy()
            out[name] = {"psnr_db": psnr(got / 255.0, want / 255.0),
                         "max_diff": int(np.abs(got.astype(np.int16) - want).max())}
    log("phase 8g: the card's chain against the reference's decodes (fixture): " + ", ".join(
        f"{n} {r['psnr_db']:.2f} dB (max {r['max_diff']})" for n, r in out.items())
        + f" (min {PSNR_MIN_DB})")
    if not all(r["psnr_db"] >= PSNR_MIN_DB for r in out.values()):
        raise AssertionError(f"phase 8g: the card's chain against the fixture: {out}")
    return out


class _LoadProbe:
    """While a CLI runs in process: the items ``ImageFolderDataset`` loads
    (their paths) and nvJPEG's decodes, counted from the Loader's threads."""

    def __init__(self):
        import threading

        from collaborative_distillation_tpu_torch.data import nvjpeg_codec, pipeline
        self.nj, self.cls = nvjpeg_codec, pipeline.ImageFolderDataset
        self.lock = threading.Lock()
        self.paths, self.decodes = [], 0

    def __enter__(self):
        probe, get, dec = self, self.cls.__getitem__, self.nj.decode_jpeg
        self.orig = get, dec

        def getitem(ds, idx):
            item = get(ds, idx)
            with probe.lock:
                probe.paths.append(ds.paths[idx])
            return item

        def decode(*a, **kw):
            img = dec(*a, **kw)
            with probe.lock:
                probe.decodes += 1
            return img

        self.cls.__getitem__, self.nj.decode_jpeg = getitem, decode
        return self

    def __exit__(self, *exc):
        self.cls.__getitem__, self.nj.decode_jpeg = self.orig


def jpeg_train_cli_runs(torch, kc, tmp, jpegs, pngs) -> dict:
    """8g: ``cli.train`` wct_se in process at stage 5 x 16 x 256^2 without
    ``--cache_data`` (every item decoded in its batch), f32 and ``--bf16``,
    on the JPEG folder ``jpegs`` ({path: (H, W)}) and on 8c's PNG folder
    ``pngs``, the resize kernels' counts zeroed before each run: each
    step's launches the step's own, the loss on the first batch falling
    over 1 + 8 steps, nvJPEG's decodes equal to the items loaded (none for
    PNGs), the resize kernels' launches equal to the loaded files' plans;
    images/s from the median step (steps 2-8) and from the median wall
    between step ends (the loader's waits included), the torch peak and
    nvJPEG's own memory."""
    from collaborative_distillation_tpu_torch.cli import train as cli
    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    from collaborative_distillation_tpu_torch.train.trainer import Trainer
    root = os.path.join(tmp, "train_weights")
    folders = {"jpeg": os.path.dirname(next(iter(jpegs))), "png": pngs}
    out = {}
    cwd = os.getcwd()
    os.chdir(tmp)   # the CLI writes Experiments/ in its working directory
    try:
        for bf16 in (False, True):
            for fmt, folder in folders.items():
                tag = f"{fmt}_{'bf16' if bf16 else 'f32'}"
                argv = ["--mode", "wct_se", "--pretrained_init", "--weights_root", root,
                        "--stage", str(TRAIN_STAGE), "-b", str(TRAIN_N), "--content_train",
                        folder, "--device", "cuda", "--print_interval", "1",
                        "--save_interval", "100", "--max_steps", str(JPEG_TRAIN_STEPS),
                        "-p", "train_" + tag] + (["--bf16"] if bf16 else [])
                for k in kc.DATA_KERNELS:
                    k.launches = 0
                nj.memory(reset_peak=True)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with _StepProbe(torch, kc, Trainer) as probe, _LoadProbe() as load:
                    t0 = time.perf_counter()
                    cli.main(argv)
                    wall = time.perf_counter() - t0
                launches = {k.__name__: k.launches for k in kc.DATA_KERNELS}
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                mem = nj.memory()
                steps = probe.steps
                want = {**{k.__name__: 0 for k in probe.kernels},
                        **_train_launches("wct_se", bf16)}
                if len(steps) != JPEG_TRAIN_STEPS or any(st["launches"] != want for st in steps):
                    raise AssertionError(f"phase 8g: {tag}: {len(steps)} steps, launches "
                                         f"{[st['launches'] for st in steps]} != {want}")
                want_data = (_chain_launches([jpegs[p] for p in load.paths]) if fmt == "jpeg"
                             else {k.__name__: 0 for k in kc.DATA_KERNELS})
                decodes = len(load.paths) if fmt == "jpeg" else 0
                if (launches != want_data or load.decodes != decodes
                        or (fmt == "jpeg" and not all(launches.values()))):
                    raise AssertionError(f"phase 8g: {tag}: {len(load.paths)} items, "
                                         f"{load.decodes} nvJPEG decodes (want {decodes}), "
                                         f"resize launches {launches} != {want_data}")
                totals = _loss_falls(torch, probe.trainer, probe.first)
                if not (all(np.isfinite(totals)) and min(totals[1:]) < totals[0]):
                    raise AssertionError(f"phase 8g: {tag}: the loss on the first batch did "
                                         f"not fall over 1 + 8 steps: {totals}")
                step_s = statistics.median(st["s"] for st in steps[1:])
                gap_s = statistics.median(b["end"] - a["end"] for a, b in zip(steps, steps[1:]))
                out[tag] = {"steps_s": [st["s"] for st in steps], "median_step_s": step_s,
                            "median_wall_s": gap_s, "images_per_s": TRAIN_N / step_s,
                            "walls_s": [b["end"] - a["end"] for a, b in zip(steps, steps[1:])],
                            "images_per_s_wall": TRAIN_N / gap_s, "items": len(load.paths),
                            "nvjpeg_decodes": load.decodes, "launches": launches,
                            "peak_gib": peak, "nvjpeg_memory": mem, "wall_s": wall,
                            "first_batch_totals": totals}
                each = ", ".join(f"{st['s'] * 1e3:.0f}" for st in steps)
                walls = ", ".join(f"{(b['end'] - a['end']) * 1e3:.0f}"
                                  for a, b in zip(steps, steps[1:]))
                log(f"phase 8g: cli.train wct_se {tag} (no --cache_data) stage {TRAIN_STAGE} x "
                    f"{TRAIN_N} x {TRAIN_HW}^2: median step {step_s * 1e3:.1f} ms over steps "
                    f"2-{JPEG_TRAIN_STEPS} ({TRAIN_N / step_s:.2f} images/s), median wall "
                    f"between steps {gap_s * 1e3:.1f} ms ({TRAIN_N / gap_s:.2f} images/s, the "
                    f"loader's waits included); steps {each} ms, walls between them {walls} "
                    f"ms (an epoch is {len(os.listdir(folder)) // TRAIN_N} steps: its first "
                    f"waits for a new pool's batch); "
                    f"{len(load.paths)} "
                    f"items loaded, {load.decodes} nvJPEG decodes, resize launches {launches}; "
                    f"torch peak {peak:.2f} GiB, nvJPEG memory {mem}; the first batch's loss "
                    f"over 1 + 8 steps {', '.join(f'{t:.6g}' for t in totals)}; wall {wall:.1f} s")
    finally:
        os.chdir(cwd)
    return out


def jpeg_training(torch, kc, c512, s512, tmp, cached) -> dict:
    """Phase 8g: JPEG training folders decoded on the card, with its own
    clock; ``cached``: 8c's and 8e's wct_se runs (PNGs, ``--cache_data``),
    printed beside."""
    t0 = time.perf_counter()
    sizes = jpeg_train_sizes(TRAIN_IMAGES) + list(JPEG_TRAIN_EDGE)
    files = write_training_jpegs(torch, c512, s512, os.path.join(tmp, "train_jpegs"), sizes)
    out = {"files": len(files), "fixture": jpeg_fixture_chain(torch),
           "kernels": jpeg_kernel_checks(torch, kc, files),
           "cli": jpeg_train_cli_runs(torch, kc, tmp, files, os.path.join(tmp, "train_images"))}
    for dtype in ("f32", "bf16"):
        r, c = out["cli"], cached[dtype]["wct_se"]
        log(f"phase 8g: {dtype} images/s, JPEG folder {r[f'jpeg_{dtype}']['images_per_s']:.2f} "
            f"(wall {r[f'jpeg_{dtype}']['images_per_s_wall']:.2f}), PNG folder "
            f"{r[f'png_{dtype}']['images_per_s']:.2f} (wall "
            f"{r[f'png_{dtype}']['images_per_s_wall']:.2f}), both without --cache_data; the "
            f"cached PNG run {c['images_per_s']:.2f}")
    out["phase8g_s"] = time.perf_counter() - t0
    log(f"phase 8g: {out['phase8g_s']:.1f} s")
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_processes(argvs, label, cwd=HERE, envs=None) -> float:
    """Start one process per argv (with ``envs``' extra variables), wait for
    all (600 s), stop any left; raises naming ``label`` with their output
    if one failed; returns the wall seconds."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env={**os.environ, **(envs[i] if envs else {})})
             for i, argv in enumerate(argvs)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"--cross-card: {label}: exit codes "
                             f"{[p.returncode for p in procs]}\n" + "\n".join(logs))
    return time.perf_counter() - t0


def dp_worker(rank: int, world: int, port: int, path: str) -> int:
    """One of ``--cross-card``'s data-parallel processes: card ``rank`` of
    ``world``, joined through ``initialize_multihost`` over NCCL, a mesh of
    its one card; in float32 and bf16, phase 8f's wct_se steps on its rows
    of the global batches (TRAIN_N // world images a process), each timed as in
    8f (the all-reduce waits for every process); writes the first step's
    losses, gradient and masters and the times to ``path``."""
    import torch
    from collaborative_distillation_tpu_torch.parallel.mesh import (initialize_multihost,
                                                                    make_mesh)
    from collaborative_distillation_tpu_torch.train.trainer import TrainConfig, Trainer
    torch.cuda.set_device(rank)
    initialize_multihost(f"127.0.0.1:{port}", world, rank)
    try:
        with np.load(os.path.join(HERE, "collaborative_distillation_tpu_torch", "data",
                                  "photo_pair_512.npz")) as d:
            student, frozen, batches = dp_setup(torch, d["content"], d["style"])
        out = {}
        for dtype in ("float32", "bfloat16"):
            cfg = TrainConfig(mode="wct_se", stage=TRAIN_STAGE, batch_size=TRAIN_N,
                              compute_dtype=dtype)
            tr = Trainer(cfg, student, frozen, mesh=make_mesh(data=1, devices=[f"cuda:{rank}"]))
            per = TRAIN_N // world
            mine = [b[rank * per:(rank + 1) * per] for b in batches]
            losses, rec = tr.train_step(mine[0])
            out.update({f"{dtype}/loss/{k}": float(v) for k, v in losses.items()})
            out[f"{dtype}/rec_ok"] = (tuple(rec.shape) == (TRAIN_N, TRAIN_HW, TRAIN_HW, 3)
                                      and bool(torch.isfinite(rec).all()))
            for n, leaf in tr.params.items():
                for k, t in leaf.items():
                    out[f"{dtype}/grad/{n}/{k}"] = t.grad.cpu().numpy()
                    out[f"{dtype}/params/{n}/{k}"] = t.detach().cpu().numpy()
            times = []
            for i in range(1, TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.train_step(mine[i % len(mine)])
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0, t1 - t0))
            out[f"{dtype}/steps_s"] = np.array([t for t, _ in times])
            out[f"{dtype}/enqueue_s"] = np.array([e for _, e in times])
        np.savez(path, **out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def dp_processes(torch, setup, single, world: int, tmp) -> dict:
    """``--cross-card``: ``world`` processes (this script with
    ``--dp-worker``), one card each, joined by ``initialize_multihost`` over
    NCCL, the first step on the same global batch against the single-device
    step on cuda:0 from the same weights (8f's tolerances; every process's
    masters bit-identical to process 0's), then timed; ``single``:
    :func:`dp_compare`'s results by dtype, printed beside."""
    from collaborative_distillation_tpu_torch.train.trainer import TrainConfig, Trainer
    port = _free_port()
    paths = [os.path.join(tmp, f"dp_worker{world}_{r}.npz") for r in range(world)]
    wall = _run_processes([[sys.executable, os.path.abspath(__file__), "--dp-worker", str(r),
                            str(world), str(port), paths[r]] for r in range(world)],
                          f"{world} data-parallel processes")
    got = [dict(np.load(p)) for p in paths]
    student, frozen, batches = setup
    out = {"processes": world, "wall_s": wall}
    for dtype in ("float32", "bfloat16"):
        bf16 = dtype == "bfloat16"
        one = Trainer(TrainConfig(mode="wct_se", stage=TRAIN_STAGE, batch_size=TRAIN_N,
                                  compute_dtype=dtype), student, frozen, device="cuda:0")
        losses, _ = one.train_step(batches[0])
        want = {"losses": {k: float(v) for k, v in losses.items()},
                "grads": {n: {k: t.grad.cpu() for k, t in leaf.items()}
                          for n, leaf in one.params.items()}}
        del one
        errs = []
        for g in got:
            mine = {"losses": {k.split("/")[-1]: float(v) for k, v in g.items()
                               if k.startswith(f"{dtype}/loss/")},
                    "grads": {n: {k: torch.from_numpy(g[f"{dtype}/grad/{n}/{k}"]) for k in leaf}
                              for n, leaf in want["grads"].items()}}
            errs.append(_dp_errors(torch, mine, want, bf16))
        same = all(np.array_equal(got[0][k], g[k]) for g in got[1:] for k in got[0]
                   if k.startswith(f"{dtype}/params/"))
        loss_tol, grad_tol = (BF16_LOSS_REL, BF16_STEP_REL) if bf16 else (1e-5, 1e-4)
        med = statistics.median(got[0][f"{dtype}/steps_s"])
        out[dtype] = {"errors": errs, "masters_equal": same, "median_s": med,
                      "enqueue_median_s": statistics.median(got[0][f"{dtype}/enqueue_s"]),
                      "images_per_s": TRAIN_N / med,
                      "steps_s": [float(t) for t in got[0][f"{dtype}/steps_s"]]}
        if not (same and all(g[f"{dtype}/rec_ok"] for g in got) and all(
                e["loss_rel_err"] <= loss_tol and e["grad_err"] <= grad_tol for e in errs)):
            raise AssertionError(f"--cross-card: {world} processes over NCCL, {dtype}: "
                                 f"{out[dtype]}")
    log(f"cross-card: {world} processes over NCCL (initialize_multihost, one card each, "
        f"{TRAIN_N // world} images a process) vs one device: " + "; ".join(
            f"{d} first step losses {max(e['loss_rel_err'] for e in out[d]['errors']):.2e} "
            f"rel, gradient {max(e['grad_err'] for e in out[d]['errors']):.2e}, masters "
            f"bit-identical; median step {out[d]['median_s'] * 1e3:.1f} ms (host enqueue "
            f"{out[d]['enqueue_median_s'] * 1e3:.1f}) over steps 2-{TRAIN_STEPS}, "
            f"{out[d]['images_per_s']:.2f} images/s against one device's "
            f"{single[d]['images_per_s']:.2f}" for d in ("float32", "bfloat16"))
        + f" ({wall:.1f} s for the processes)")
    return out


DP_CLI_STEPS = 10   # one epoch of DP_CLI_STEPS x TRAIN_N images


def dp_cli_processes(torch, setup, c512, s512, world: int, tmp, fmt="png") -> dict:
    """``--cross-card``: ``cli.train`` with its default ``--data_parallel
    0`` on ``world`` (every visible) cards, which starts a process a card
    over NCCL, and with ``--data_parallel 1`` (one card) beside it; wct_se
    at stage 5 x 16 x 256^2, 8f's seeded weights (``--weights_root`` and
    ``--SE``), one epoch of DP_CLI_STEPS steps over as many batches of PNGs
    (``fmt="jpeg"``: JPEGs of phase 8g's mix, decoded and resized on each
    process's card): each exits 0, process 0 alone writes the run (its log
    says ``DP x world (one process a device)``), one checkpoint. Images/s
    from the log's MPix/s (a step's wall, the loader's wait and the loss
    read-back included), the median over steps 3 on: the first line holds
    the loader's start and the second the grid written after the first."""
    import re

    from collaborative_distillation_tpu_torch.models.zoo import save_tree_npz
    student, frozen, _ = setup
    root, data = os.path.join(tmp, "dp_weights"), os.path.join(tmp, f"dp_{fmt}")
    if not os.path.isdir(root):
        save_tree_npz(frozen["be"], os.path.join(root, "original", f"e{TRAIN_STAGE}.npz"))
        save_tree_npz(frozen["bd"], os.path.join(root, "original", f"d{TRAIN_STAGE}.npz"))
        save_tree_npz(student, os.path.join(root, f"se{TRAIN_STAGE}.npz"))
    if fmt == "jpeg":
        write_training_jpegs(torch, c512, s512, data, jpeg_train_sizes(DP_CLI_STEPS * TRAIN_N))
    else:
        _write_training_pngs(torch, c512, s512, data, DP_CLI_STEPS * TRAIN_N)
    argv = [sys.executable, "-m", "collaborative_distillation_tpu_torch.cli.train", "--mode",
            "wct_se", "--stage", str(TRAIN_STAGE), "-b", str(TRAIN_N), "--content_train", data,
            "--weights_root", root, "--SE", os.path.join(root, f"se{TRAIN_STAGE}.npz"),
            "--max_steps", str(DP_CLI_STEPS), "--print_interval", "1", "--device", "cuda"]
    out = {}
    for cards, dp, want in ((1, "1", "mesh: single device"),
                            (world, "0" if world == torch.cuda.device_count() else str(world),
                             f"mesh: DP x {world} (one process a device)")):
        run = os.path.join(tmp, f"dp_cli{cards}_{fmt}")
        os.makedirs(run)
        wall = _run_processes([argv + ["-p", f"dp_cli{cards}", "--data_parallel", dp]],
                              f"cli.train on {cards} cards ({fmt})", cwd=run,
                              envs=[{"PYTHONPATH": HERE}])
        runs = os.listdir(os.path.join(run, "Experiments")) if os.path.isdir(
            os.path.join(run, "Experiments")) else []
        text, ckpts = "", []
        if len(runs) == 1:
            wdir = os.path.join(run, "Experiments", runs[0], "weights")
            text = open(os.path.join(wdir, [f for f in os.listdir(wdir)
                                            if f.startswith("log_")][0])).read()
            ckpts = [f for f in os.listdir(wdir) if f.endswith(".npz")]
        mpix = [float(m.group(1)) for m in re.finditer(r"\(([\d.]+) MPix/s", text)]
        if len(runs) != 1 or want not in text or len(ckpts) != 1 or \
                f"max_steps {DP_CLI_STEPS} reached" not in text or len(mpix) != DP_CLI_STEPS:
            raise AssertionError(f"--cross-card: cli.train on {cards} cards: runs {runs}, "
                                 f"checkpoints {ckpts}\n{text}")
        ips = statistics.median(mpix[2:]) * 1e6 / TRAIN_HW ** 2
        out[cards] = {"data_parallel": dp, "wall_s": wall, "mpix_per_s": mpix,
                      "images_per_s": ips}
        log(f"cross-card: cli.train wct_se stage {TRAIN_STAGE} x {TRAIN_N} x {TRAIN_HW}^2 on "
            f"{fmt.upper()}s, --data_parallel {dp} on {cards} card(s): exited 0 in {wall:.1f} s, "
            f"process 0 "
            f"wrote the one run ('{want}', one checkpoint); MPix/s a step {mpix}: "
            f"{ips:.2f} images/s (median of steps 3-{DP_CLI_STEPS})")
    log(f"cross-card: cli.train images/s on {fmt.upper()}s, default on {world} cards against one: "
        f"{out[world]['images_per_s']:.2f} / {out[1]['images_per_s']:.2f} = "
        f"{out[world]['images_per_s'] / out[1]['images_per_s']:.2f}x")
    return out


def dp_cross_card(torch, kc, c512, s512, tmp) -> dict:
    """``--cross-card``: 8f's check with one replica a card in this process
    at 2 cards and at 4 where present, float32 and bf16; then the same
    numbers of processes, one card each (:func:`dp_processes`); images/s
    at 1, 2 and 4 cards both ways; ``cli.train`` on every card against one,
    on a PNG folder and on a JPEG folder (:func:`dp_cli_processes`)."""
    setup = dp_setup(torch, c512, s512)
    counts = [n for n in (2, 4) if n <= torch.cuda.device_count()]
    out = {dtype: {n: dp_compare(torch, kc, setup, dtype, [f"cuda:{i}" for i in range(n)],
                                 "cross-card") for n in counts}
           for dtype in ("float32", "bfloat16")}
    single = {dtype: out[dtype][counts[0]]["single"] for dtype in out}
    out["processes"] = {n: dp_processes(torch, setup, single, n, tmp) for n in counts}
    out["cli"] = dp_cli_processes(torch, setup, c512, s512, counts[-1], tmp)
    out["cli_jpeg"] = dp_cli_processes(torch, setup, c512, s512, counts[-1], tmp, "jpeg")
    for cards in (1, counts[-1]):
        log(f"cross-card: cli.train images/s on {cards} card(s), JPEG folder "
            f"{out['cli_jpeg'][cards]['images_per_s']:.2f} (decoded on the card) against PNG "
            f"folder {out['cli'][cards]['images_per_s']:.2f}")
    for dtype in ("float32", "bfloat16"):
        log(f"cross-card: data-parallel wct_se {dtype} images/s: 1 card "
            f"{single[dtype]['images_per_s']:.2f}; " + "; ".join(
                f"{n} cards {out[dtype][n]['images_per_s']:.2f} in one process, "
                f"{out['processes'][n][dtype]['images_per_s']:.2f} one process a card"
                for n in counts))
    return out


def training(torch, kc, c512, s512, tmp, teachers) -> dict:
    """Phase 8: the training path (8a, 8b, 8c, 8d, 8e, 8f, 8g), with its own clock;
    ``teachers``: phase 9c's store."""
    t0 = time.perf_counter()
    out = {"autograd": train_autograd_checks(torch), "card_vs_cpu": train_card_vs_cpu(torch),
           "cli": train_cli_runs(torch, kc, c512, s512, tmp, teachers),
           "teacher_convs": teacher_conv_times(torch)}
    if out["teacher_convs"]["first_launches"]:
        raise AssertionError(f"phase 8d: {out['teacher_convs']['first_launches']} convs of a "
                             f"wct_se step plan the first kernel")
    out["bf16"] = training_bf16(torch, kc, c512, s512, tmp, teachers, out["cli"])
    out["data_parallel"] = train_data_parallel(torch, kc, c512, s512)
    out["jpeg"] = jpeg_training(torch, kc, c512, s512, tmp,
                                {"f32": out["cli"], "bf16": out["bf16"]["cli"]})
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


def nvjpeg_load(nj, seconds: float) -> dict:
    """Phase 1: the nvJPEG shim built from ``data/csrc/nvjpeg_codec.cpp``
    and loaded; what it linked and which libnvjpeg the process mapped. The
    script fails here where nvJPEG does not load on the card."""
    if not nj.available():
        raise AssertionError(f"nvJPEG did not load on the card: {nj.unavailable_reason()}")
    with open("/proc/self/maps") as f:
        mapped = sorted({line.split()[-1] for line in f if "libnvjpeg" in line})
    out = {"seconds": seconds, "version": nj.version(), "mapped": mapped,
           **{k: nj.last_build.get(k) for k in ("dir", "built", "command")}}
    log(f"phase 1: nvJPEG {out['version']} shim (built={out['built']}, {seconds:.1f} s, "
        f"{out['dir']}): {' '.join(os.path.basename(x) for x in out['command'][:1])} "
        f"{' '.join(out['command'][1:])}; mapped {', '.join(mapped)}")
    return out


def unpooled_conv_checks(torch, kc, pyr, stages, h, w) -> list:
    """Phase 2 (and 10e on a bf16 pyramid): conv3x3 against its plain
    version at every decoder conv of the photo-WCT cascade that reads a
    max-unpooled map (three of every four values exactly 0), with the
    decoder's weights, at an (h, w) cascade, in the pyramid's dtype (float32
    to CONV_TOL, bf16 within one bf16 ulp); each timed beside its plain
    version and cuDNN's reflect conv (one call a cascade each)."""
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
                    wt, b = params[l.name]["w"].contiguous(), params[l.name]["b"].contiguous()
                    src = torch.rand((1, hh, ww, l.in_ch), generator=gen, device="cuda")
                    x = max_unpool_2x2(*max_pool_2x2_with_argmax(src.to(wt.dtype)), (hh, ww))
                    got = kc.conv3x3_reflect(x, wt, b, l.relu)
                    ref = kc.conv3x3_reflect.plain(x, wt, b, l.relu)
                    err = float((got.float() - ref.float()).abs().max())
                    zeros = float((x == 0).float().mean())
                    shape = [1, hh, ww, l.in_ch, l.out_ch, l.relu]
                    if wt.dtype == torch.bfloat16:
                        r = ref.float()
                        bound = torch.clamp(r.abs() * BF16_ULP, min=BF16_FLOOR * float(
                            r.abs().max()))
                        misses = int(((got.float() - r).abs() > bound).sum())
                        scale, tol, ok = float(r.abs().max()), None, misses == 0
                        peak, itemsize = PEAK_BF16_FLOPS, 2
                    else:
                        scale = float(x.abs().max() * wt.abs().sum(dim=(0, 1, 2)).max()
                                      + b.abs().max())
                        tol = CONV_TOL * scale
                        ok, peak, itemsize = err <= tol, PEAK_FP32_FLOPS, 4
                    rows.append({"kernel": "conv3x3_reflect" if itemsize == 4
                                 else "conv3x3_reflect_bf16", "unpooled": True,
                                 "shape": shape, "zero_share": zeros, "max_abs_err": err,
                                 "max_rel_err": err / max(scale, 1e-30), "tol": tol, "ok": ok})
                    if not ok:
                        raise AssertionError(f"conv3x3 on an unpooled {wt.dtype} map {shape}: "
                                             f"error {err} past the tolerance")
                    lib = torch.nn.Conv2d(l.in_ch, l.out_ch, 3, padding=1,
                                          padding_mode="reflect", device="cuda", dtype=wt.dtype)
                    lib.weight.copy_(wt.permute(3, 2, 0, 1))
                    lib.bias.copy_(b)
                    xn = x.permute(0, 3, 1, 2)
                    nbytes, flops = work("conv3x3_reflect", shape, itemsize)
                    rows[-1].update(
                        calls=1, ms=cuda_ms(torch, lambda: kc.conv3x3_reflect(x, wt, b, l.relu), 10),
                        plain_ms=cuda_ms(torch, lambda: kc.conv3x3_reflect.plain(x, wt, b, l.relu),
                                         10),
                        library_ms=cuda_ms(torch, lambda: lib(xn), 10),
                        bytes_ms=nbytes / PEAK_BYTES * 1e3, flops_ms=flops / peak * 1e3)
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
        card = torch.clamp(img[0, :h, :w], 0.0, 1.0).float().cpu().numpy()
        cpu = torch.clamp(img_cpu[0, :h, :w], 0.0, 1.0).float().numpy()
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


# ---- phase 9e: the model-asset tools ----------------------------------------------

ASSET_RESIZE = (1024, 768)     # 9e(f): imgtools resize --size W H
# 9e(f): a JPEG written by imgtools (quality 75, PIL's default) against the
# same pixels before the encode; a q75 encode of these photos reads ~35-40 dB
# on the CPU (libjpeg), so the floor only refuses a wrong image
ASSET_JPEG_MIN_DB = 30.0


def _legacy_pth(torch, tree, path) -> None:
    """A store tree as the reference's ``.pth``: the OIHW state dict wrapped
    as ``{"epoch": 0, "model": sd}``, in torch 0.4.1's legacy (non-zip)
    format."""
    sd = {}
    for name, leaf in tree.items():
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            leaf["w"].transpose(3, 2, 0, 1)))
        sd[f"{name}.bias"] = torch.from_numpy(leaf["b"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"epoch": 0, "model": sd}, path, _use_new_zipfile_serialization=False)


def _same_tree(a, b) -> bool:
    """Two ``{layer: {"w", "b"}}`` numpy trees equal bit for bit."""
    return sorted(a) == sorted(b) and all(
        sorted(a[n]) == sorted(b[n]) and all(
            a[n][kk].dtype == b[n][kk].dtype and a[n][kk].shape == b[n][kk].shape
            and a[n][kk].tobytes() == b[n][kk].tobytes() for kk in a[n]) for n in a)


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output kept; -> (result, seconds, text)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, time.perf_counter() - t0, buf.getvalue()


def _asset_train_run(torch, kc, argv, tag, mode_key) -> tuple:
    """9e(c): one ``cli.train`` run in process (``argv`` + ``-p tag``),
    each step's launches held to the specs' (``_train_launches(mode_key)``)
    and its losses finite. -> (probe, checkpoint path, wall s)."""
    from collaborative_distillation_tpu_torch.cli import train as cli
    from collaborative_distillation_tpu_torch.train.trainer import Trainer
    with _StepProbe(torch, kc, Trainer) as probe:
        _, wall, _ = _quiet(cli.main, argv + ["-p", tag])
    want = {**{kk.__name__: 0 for kk in probe.kernels}, **_train_launches(mode_key)}
    _check_counts(f"phase 9e(c): {tag}, one step", probe.steps[0]["launches"], want)
    for i, st in enumerate(probe.steps):
        if st["launches"] != want or not all(np.isfinite(v) for v in st["losses"].values()):
            raise AssertionError(f"phase 9e(c): {tag} step {i + 1}: launches {st['launches']} "
                                 f"(want {want}), losses {st['losses']}")
    if len(probe.steps) != TRAIN_STEPS:
        raise AssertionError(f"phase 9e(c): {tag} took {len(probe.steps)} steps")
    (run,) = [d for d in os.listdir("Experiments") if d.endswith("_" + tag)]
    wdir = os.path.join("Experiments", run, "weights")
    (ckpt,) = [os.path.join(wdir, f) for f in os.listdir(wdir) if f.endswith(".npz")]
    return probe, os.path.abspath(ckpt), wall


def _dcp_resume(torch, trainer, batch, base) -> dict:
    """9e(d): ``trainer``'s state saved through ``save_checkpoint_dcp`` and
    ``save_checkpoint``; each loaded back into it (params and Adam state
    bit-equal to the saved ones), then one step on ``batch``: the two
    steps' masters must be bit-equal (cuDNN's deterministic algorithms for
    the backward convs, as in both resumed steps)."""
    from collaborative_distillation_tpu_torch.utils.checkpoint import (
        _flatten, load_checkpoint, load_checkpoint_dcp, save_checkpoint, save_checkpoint_dcp)
    state = trainer.state(epoch=2, step=TRAIN_STEPS)
    saved = {kk: v for kk, v in _flatten(state).items() if not kk.startswith("meta/")}
    dcp_dir, npz = os.path.join(base, "state_dcp"), os.path.join(base, "state.npz")
    _, dcp_save_s, _ = _quiet(save_checkpoint_dcp, dcp_dir, state)
    _, npz_save_s, _ = _quiet(save_checkpoint, npz, state)
    loads = {"dcp": lambda: load_checkpoint_dcp(dcp_dir, trainer.state()),
             "npz": lambda: load_checkpoint(npz, trainer.state())}
    masters, load_s = {}, {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for how in ("dcp", "npz"):
            t0 = time.perf_counter()
            meta = trainer.load_state(loads[how]())
            load_s[how] = time.perf_counter() - t0
            now = {kk: v for kk, v in _flatten(trainer.state()).items()
                   if not kk.startswith("meta/")}
            if (sorted(now) != sorted(saved) or int(meta["step"]) != TRAIN_STEPS
                    or any(now[kk].tobytes() != saved[kk].tobytes() for kk in saved)):
                raise AssertionError(f"phase 9e(d): the {how} checkpoint did not restore the "
                                     f"saved params and Adam state bit for bit")
            trainer.train_step(batch)
            masters[how] = _flatten(trainer.params)
    finally:
        torch.backends.cudnn.deterministic = prev
    differ = [kk for kk in masters["dcp"]
              if masters["dcp"][kk].tobytes() != masters["npz"][kk].tobytes()]
    dcp_bytes = sum(os.path.getsize(os.path.join(dcp_dir, f)) for f in os.listdir(dcp_dir))
    log(f"phase 9e(d): wct_se trainer state ({len(saved)} leaves, params and Adam state) "
        f"through save_checkpoint_dcp in {dcp_save_s * 1e3:.1f} ms ({dcp_bytes} bytes, "
        f"{len(os.listdir(dcp_dir))} files) and save_checkpoint in {npz_save_s * 1e3:.1f} ms; "
        f"loads {load_s['dcp'] * 1e3:.1f} / {load_s['npz'] * 1e3:.1f} ms, both bit-equal to the "
        f"saved state; one step resumed from each: {len(differ)} of {len(masters['dcp'])} "
        f"master leaves differ")
    if differ:
        raise AssertionError(f"phase 9e(d): one step resumed from the DCP and the npz "
                             f"checkpoints gives other masters: {differ}")
    return {"leaves": len(saved), "dcp_save_s": dcp_save_s, "npz_save_s": npz_save_s,
            "load_s": load_s, "dcp_bytes": dcp_bytes, "masters_differ": len(differ)}


def _asset_imgtools(torch, c2k, s2k, base) -> dict:
    """9e(f): ``cli.imgtools crop-center`` and ``resize`` on the card (its
    default device) over a folder of two 2048^2 PNGs and two 2048^2 JPEGs
    written by nvJPEG: each command's wall; the PNG outputs equal to the
    square crop (the whole image) and to ``utils/image.py:resize`` of the
    source exactly, the JPEG outputs (quality 75) within ASSET_JPEG_MIN_DB of
    the same pixels, decoded by nvJPEG."""
    from collaborative_distillation_tpu_torch.cli import imgtools
    from collaborative_distillation_tpu_torch.utils.image import read_image, resize, save_image
    folder = os.path.join(base, "imgtools")
    os.makedirs(folder)
    for name, img in (("c.png", c2k), ("s.png", s2k), ("c.jpg", c2k), ("s.jpg", s2k)):
        save_image(img, os.path.join(folder, name), device="cuda")
    src = {n: read_image(os.path.join(folder, n), device="cuda") for n in os.listdir(folder)}
    rc_c, crop_s, _ = _quiet(imgtools.main, ["crop-center", folder])
    rc_r, resize_s, _ = _quiet(imgtools.main, ["resize", folder, "--size",
                                               *map(str, ASSET_RESIZE)])
    files = sorted(os.listdir(folder))
    if rc_c or rc_r or len(files) != 4 + 4 + 8:
        raise AssertionError(f"phase 9e(f): imgtools exited {rc_c}, {rc_r}; files {files}")
    worst = float("inf")
    for n, img in src.items():
        stem, ext = os.path.splitext(n)
        for suffix, want in (("_cropped", img), ("_resized", resize(img, *ASSET_RESIZE)),
                             ("_cropped_resized", resize(img, *ASSET_RESIZE))):
            got = read_image(os.path.join(folder, stem + suffix + ext), device="cuda")
            if got.shape != want.shape:
                raise AssertionError(f"phase 9e(f): {stem + suffix + ext} {got.shape}")
            if ext == ".png":
                if not np.array_equal(got, want):
                    raise AssertionError(f"phase 9e(f): {stem + suffix + ext} differs")
            else:
                worst = min(worst, _psnr_u8(torch, got, want))
    if not worst >= ASSET_JPEG_MIN_DB:
        raise AssertionError(f"phase 9e(f): a q75 JPEG output reads {worst:.2f} dB")
    log(f"phase 9e(f): cli.imgtools on the card over 2 PNGs + 2 nvJPEG JPEGs at 2048^2: "
        f"crop-center {crop_s:.3f} s (4 files), resize --size {ASSET_RESIZE[0]} "
        f"{ASSET_RESIZE[1]} {resize_s:.3f} s (8 files: the crops too); PNG outputs exact, "
        f"q75 JPEG outputs >= {worst:.2f} dB (min {ASSET_JPEG_MIN_DB})")
    return {"crop_center_s": crop_s, "resize_s": resize_s, "jpeg_min_db": worst}


def asset_tools(torch, kc, c512, s512, c2k, s2k, tmp, teachers) -> dict:
    """Phase 9e: the model-asset tools on phase 9c's teacher store
    (``teachers``), at full widths: (a) its e5 and d5 as the reference's
    legacy ``.pth`` files in a ``trained_models/`` layout, ``cli.convert``
    back to the store bit for bit; (b) ``cli.prune`` of the encoders and
    decoders of stages 1-5 into ``16x_base/``, shapes the 16x specs', each
    timed; (c) ``cli.train --mode wct_se --stage 5 --pretrained_init`` on
    the pruned init and 8c's 48 PNGs, then ``wct_sd`` on the trained
    encoder (``cli.export``), six steps each at stage 5 x 16 x 256^2,
    launches per step the specs', losses finite and falling on the first
    batch over 1 + 8 steps (``_loss_falls``), the median step and images/s;
    (d) the wct_se trainer's state through ``save_checkpoint_dcp`` and
    ``save_checkpoint``, one step resumed from each bit-equal (``_dcp_resume``);
    (e) ``cli.export`` of the trained stage-5 pair and
    ``WCTEngine(stages=(5,))`` on the 512^2 pair with the counters zeroed:
    the plain path's counts, output finite; (f) ``cli.imgtools`` on the card
    (``_asset_imgtools``)."""
    import shutil

    from collaborative_distillation_tpu_torch.cli import convert, export, prune
    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    from collaborative_distillation_tpu_torch.models.zoo import load_stage_params, load_tree_npz
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    k = TRAIN_STAGE
    base = os.path.join(tmp, "assets")
    out = {}
    # (a) the reference's .pth files back into the store
    ref = os.path.join(base, "trained_models")
    store = {kind: load_tree_npz(os.path.join(teachers, "original", f"{kind}{k}.npz"))
             for kind in "ed"}
    _legacy_pth(torch, store["e"], os.path.join(ref, "wct_se_16x_new", f"{k}SE.pth"))
    _legacy_pth(torch, store["d"], os.path.join(ref, "our_BD", f"{k}BD_E30S0.pth"))
    conv_root = os.path.join(base, "converted")
    rc, convert_s, text = _quiet(convert.main, ["--reference", ref, "--out", conv_root])
    got = {"e": load_tree_npz(os.path.join(conv_root, "16x", f"e{k}.npz")),
           "d": load_tree_npz(os.path.join(conv_root, "original", f"d{k}.npz"))}
    missing = text.count("[missing]")
    if rc or missing != 33 or not all(_same_tree(got[x], store[x]) for x in "ed"):
        raise AssertionError(f"phase 9e(a): cli.convert exited {rc}, {missing} missing, "
                             f"e{k}/d{k} equal: {[_same_tree(got[x], store[x]) for x in 'ed']}")
    log(f"phase 9e(a): 9c's e{k} and d{k} as legacy-format {{'epoch', 'model'}} .pth files "
        f"(wct_se_16x_new/{k}SE.pth, our_BD/{k}BD_E30S0.pth): cli.convert in "
        f"{convert_s:.3f} s, both back to the store bit for bit ({missing} [missing] lines)")
    out["convert_s"] = convert_s
    # (b) L1-pruned student inits of stages 1-5
    root = os.path.join(base, "weights")
    shutil.copytree(os.path.join(teachers, "original"), os.path.join(root, "original"))
    prune_s = {}
    for kk in range(1, 6):
        for kind, spec in (("encoder", encoder_spec("16x", kk, aux=True)),
                           ("decoder", decoder_spec("16x", kk))):
            name = f"{kind[0]}{kk}"
            dst = os.path.join(root, "16x_base", f"{name}.npz")
            rc, prune_s[name], _ = _quiet(prune.main, [
                "--teacher", os.path.join(root, "original", f"{name}.npz"), "--kind", kind,
                "--stage", str(kk), "--output", dst])
            if rc:
                raise AssertionError(f"phase 9e(b): cli.prune {name} exited {rc}")
            load_stage_params(dst, spec)   # raises where a shape is not the 16x spec's
    log(f"phase 9e(b): cli.prune stages 1-5 into 16x_base/, every shape the 16x specs': "
        + ", ".join(f"{n} {s * 1e3:.1f}" for n, s in prune_s.items()) + " ms")
    out["prune_s"] = prune_s
    # (c) pruned-init training, (d) its state through both checkpoint backends
    data = os.path.join(base, "train_images")
    _write_training_pngs(torch, c512, s512, data)
    common = ["--stage", str(k), "-b", str(TRAIN_N), "--content_train", data, "--cache_data",
              "--device", "cuda", "--print_interval", "1", "--save_interval", "100",
              "--max_steps", str(TRAIN_STEPS), "--pretrained_init", "--weights_root", root]
    exported = os.path.join(base, "exported", "16x")
    cwd = os.getcwd()
    os.chdir(base)   # the CLI writes Experiments/ in its working directory
    try:
        runs = {}
        for mode, key in (("wct_se", "wct_se"), ("wct_sd", "wct_sd_perc")):
            extra = ["--SE", os.path.join(exported, f"e{k}.npz")] if mode == "wct_sd" else []
            probe, ckpt, wall = _asset_train_run(torch, kc, ["--mode", mode] + common + extra,
                                                 f"pruned_{mode}", key)
            rc, _, _ = _quiet(export.main, [ckpt, "--out", os.path.join(
                exported, f"{'e' if mode == 'wct_se' else 'd'}{k}.npz")])
            if rc:
                raise AssertionError(f"phase 9e(e): cli.export of {ckpt} exited {rc}")
            if mode == "wct_se":
                out["dcp"] = _dcp_resume(torch, probe.trainer, probe.batch, base)
            totals = _loss_falls(torch, probe.trainer, probe.first)
            if not (all(np.isfinite(totals)) and min(totals[1:]) < totals[0]):
                raise AssertionError(f"phase 9e(c): {mode}: the first batch's loss did not "
                                     f"fall over 1 + 8 steps from the pruned init: {totals}")
            times = [st["s"] for st in probe.steps[1:]]
            med = statistics.median(times)
            runs[mode] = {"median_s": med, "images_per_s": TRAIN_N / med, "wall_s": wall,
                          "steps_s": [st["s"] for st in probe.steps],
                          "losses_first": probe.steps[0]["losses"],
                          "losses_last": probe.steps[-1]["losses"],
                          "first_batch_totals": totals,
                          "launches_per_step": _train_launches(key)}
            log(f"phase 9e(c): cli.train {mode} --pretrained_init (cli.prune's 16x_base"
                f"{', the trained encoder' if extra else ''}) stage {k} x {TRAIN_N} x "
                f"{TRAIN_HW}^2: median step {med * 1e3:.1f} ms over steps 2-{TRAIN_STEPS} "
                f"({TRAIN_N / med:.2f} images/s; steps "
                f"{', '.join(f'{t * 1e3:.0f}' for t in times)} ms), wall {wall:.1f} s; "
                f"launches per step {_train_launches(key)}; losses first "
                f"{probe.steps[0]['losses']}, last {probe.steps[-1]['losses']}; the first "
                f"batch's weighted loss over 1 + 8 steps {', '.join(f'{t:.6g}' for t in totals)}")
        out["train"] = runs
    finally:
        os.chdir(cwd)
    # (e) the exported pair stylizes through the engine's plain path
    eng5 = WCTEngine(mode="16x", weights_root=os.path.dirname(exported), stages=(k,))
    calls, _ = path_calls(eng5.pyramid, eng5.stages, *c512.shape[:2])
    want = _totals(kc, calls)
    _zero(kc)
    t0 = time.perf_counter()
    img = eng5.stylize(c512, s512)
    stylize_s = time.perf_counter() - t0
    counts = _counts(kc)
    _check_counts(f"phase 9e(e): WCTEngine(stages=({k},)) on the exported pair, 512^2", counts,
                  want)
    plain = ("conv3x3_reflect", "sum_gram", "max_pool_2x2", "upsample_nearest_2x")
    change = float(np.abs(img - c512.astype(np.float32) / 255.0).mean())
    if not (img.shape == c512.shape and np.isfinite(img).all() and all(
            counts[n] > 0 for n in plain)):
        raise AssertionError(f"phase 9e(e): output {img.shape}, finite "
                             f"{bool(np.isfinite(img).all())}, launches {counts}")
    log(f"phase 9e(e): cli.export of the trained e{k}/d{k}, WCTEngine(stages=({k},)) 512^2 in "
        f"{stylize_s:.3f} s (first call), output finite, mean |out - content| {change:.4f}")
    out["stylize"] = {"s": stylize_s, "launches": counts, "mean_change": change}
    # (f) imgtools on the card
    out["imgtools"] = _asset_imgtools(torch, c2k, s2k, base)
    return out


# ---- phase 10: bfloat16 inference -----------------------------------------------

def _bf16_plan(calls) -> Counter:
    """A float32 plan's {(kernel, shape): count} on the bf16 engine: the same
    shapes on the bf16 kernels (``BF16_OF``); sum_gram stays float32."""
    out = Counter()
    for (kernel, shape), n in calls.items():
        out[(BF16_OF.get(kernel, kernel), shape)] += n
    return out


def bf16_phase(torch, kc, WCTEngine, bench, eng, slab_eng, c2k, s2k, c_uhd, calls2k, layers2k,
               calls_uhd, layers_uhd, f32_ms) -> tuple[dict, list]:
    """Phase 10 (see the module docstring): the bf16 kernels against their
    plain versions at every shape of the bf16 2048^2 plain and UHD slab
    paths, timed; both paths driven with every count zeroed before and read
    after; the warm cascades beside the float32 ones of phases 5 and 5b
    (``f32_ms``); the card's bf16 output against its float32 output and a
    bf16 encoder card vs CPU; ``cli.stylize --bf16``. Returns the phase's
    details and the kernel table's bf16 rows."""
    import tempfile

    from collaborative_distillation_tpu_torch.cli import stylize as cli
    from collaborative_distillation_tpu_torch.models.vgg import apply_encoder
    from collaborative_distillation_tpu_torch.utils.image import jpeg_or_png, save_image
    t10 = time.perf_counter()
    bf = torch.bfloat16
    out: dict = {}
    calls16, calls16_uhd = _bf16_plan(calls2k), _bf16_plan(calls_uhd)
    names16 = set(BF16_OF.values())
    # (a) kernel vs plain: every shape of both paths (timed), and edge shapes
    rows = [{**bench.run(kernel, shape, layers2k.get(shape), timed=True), "calls": n}
            for (kernel, shape), n in sorted(calls16.items(), key=str) if kernel in names16]
    rows_uhd = [{**bench.run(kernel, shape, layers_uhd.get(shape), timed=True, reps=3), "calls": n}
                for (kernel, shape), n in sorted(calls16_uhd.items(), key=str)
                if kernel in names16]
    # (N, H, W, Cin, Cout, relu[, offset]): one pixel, Cin 3 off alignment,
    # W = 2, the teachers' 512, ragged tiles; the 1x1 off alignment, a
    # 100001-wide row, no bias; pool and upsample at odd sizes and C = 3
    edge = [bench.run("conv3x3_reflect_bf16", sh) for sh in
            [(1, 1, 1, 128, 128, True), (1, 17, 33, 3, 24, True, 1), (2, 9, 2, 24, 3, False),
             (1, 16, 16, 512, 512, True), (1, 13, 45, 16, 16, True, 3),
             (1, 33, 65, 64, 128, False, 1)]]
    edge += [bench.run("conv1x1_bias_bf16", sh) for sh in
             [(1, 1, 1, 8, 8, False, True, 0), (1, 3, 100001, 24, 24, False, True, 1),
              (1, 5, 31, 128, 128, False, True, 3), (1, 7, 13, 96, 96, True, False, 0)]]
    edge += [bench.run(kernel, sh) for kernel in ("max_pool_2x2_bf16", "upsample_nearest_2x_bf16")
             for sh in [(1, 7, 9, 16), (2, 5, 4, 3), (1, 1, 5, 8)]]
    checks = rows + rows_uhd + edge
    out["checks"] = len(checks)
    log(f"phase 10a: {len(checks)} bf16 kernel-vs-plain checks passed ({len(rows)} shapes of "
        f"the bf16 2048^2 path, {len(rows_uhd)} of the UHD slab path, {len(edge)} edge): no "
        f"output past one bf16 ulp (2^-7 |plain|, floor {BF16_FLOOR} max|plain|); max rel err "
        f"{max(r['max_rel_err'] for r in checks):.3e}")

    # (b) the main paths in bf16, every count zeroed before and read after
    every = kc.KERNELS + kc.BF16_KERNELS

    def counted(fn):
        for k in every:
            k.launches = 0
        kc.conv3x3_reflect_bf16.by_template.clear()
        r = fn()
        return r, {k.__name__: k.launches for k in every}

    def expected(calls):
        return {k.__name__: sum(c for (kernel, _), c in calls.items() if kernel == k.__name__)
                for k in every}

    eng16 = WCTEngine(mode="16x", dtype=bf)
    slab16 = WCTEngine(mode="16x", dtype=bf, slab_rows=UHD_SLAB)
    for label, e, c, calls, must in (
            ("2048^2 plain", eng16, c2k, calls16, names16 - {"conv1x1_bias_bf16"}),
            (f"{UHD_H}x{UHD_W} slab_rows={UHD_SLAB}", slab16, c_uhd, calls16_uhd, names16)):
        t0 = time.perf_counter()
        img, launches = counted(lambda: e.stylize(c, s2k))
        wall = time.perf_counter() - t0
        _check_counts(f"phase 10b: bf16 stylize {label}", launches, expected(calls))
        if any(launches[n] <= 0 for n in must):
            raise AssertionError(f"phase 10b: a bf16 kernel of the {label} path never ran")
        change = float(np.abs(img - c.astype(np.float32) / 255.0).mean())
        if not (img.shape == c.shape and img.dtype == np.float32 and np.isfinite(img).all()
                and img.min() >= 0.0 and img.max() <= 1.0 and change > 0.02):
            raise AssertionError(f"phase 10b: bad bf16 {label} output: {img.shape} {img.dtype}, "
                                 f"range [{img.min()}, {img.max()}], mean change {change}")
        by_template = dict(kc.conv3x3_reflect_bf16.by_template)
        out[label] = {"launches": launches, "first_s": wall, "mean_change": change,
                      "conv3x3_bf16_by_template": by_template}
        log(f"phase 10b: bf16 {label}: {wall:.3f} s (first call, host transfer included), "
            f"float32 output finite, in [0, 1], mean |out - content| {change:.4f}; "
            f"conv3x3_reflect_bf16 launches by template {by_template}")
        del img
    launches16 = out["2048^2 plain"]["launches"]
    launches16_uhd = out[f"{UHD_H}x{UHD_W} slab_rows={UHD_SLAB}"]["launches"]

    # (b) warm cascades: 2048^2 median of 5, UHD slab median of 3, peaks, splits
    warm = {}
    with torch.inference_mode():
        sty16 = eng16._prep(s2k)
        for label, e, c, n in (("2048", eng16, c2k, 5), ("uhd", slab16, c_uhd, 3)):
            img = e._prep(c)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated() / 2**30
            runs = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e.stylize_device(img, sty16)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            warm[label] = {"runs": runs, "median": statistics.median(runs),
                           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                           "resident_before_gib": resident, "f32_median": f32_ms[label]}
            warm[label]["profile"] = profile_cascade(torch, e, img, sty16, f"phase 10b ({label})")
            del img
    out["warm"] = warm
    for label, w in warm.items():
        log(f"phase 10b: bf16 {label} cascade warm {w['median']:.2f} ms (runs "
            f"{', '.join(f'{r:.2f}' for r in w['runs'])}; style statistics included), float32 "
            f"{w['f32_median']:.2f} ms in this run (phase 5/5b); peak {w['peak_gib']:.2f} GiB "
            f"({w['resident_before_gib']:.2f} GiB held before it)")

    # (c) quality: bf16 against float32 on the card; a bf16 encoder card vs CPU
    with torch.inference_mode():
        o32 = eng.stylize_device(eng._prep(c2k), eng._prep(s2k))
        o16 = eng16.stylize_device(eng16._prep(c2k), sty16)
        db = psnr_device(torch, o16, o32)
        del o32, o16
        u32 = slab_eng.stylize_device(slab_eng._prep(c_uhd), eng._prep(s2k))
        u16 = slab16.stylize_device(slab16._prep(c_uhd), sty16)
        db_uhd = psnr_device(torch, u16, u32)
        del u32, u16
        p5 = eng16.pyramid[5]
        cpu_enc = {n: {k: t.cpu() for k, t in leaf.items()} for n, leaf in p5["enc"].items()}
        img16 = eng16._prep(c2k)
        card = apply_encoder(p5["enc"], img16, p5["enc_spec"], aux=False)["out"].float().cpu()
        cpu = apply_encoder(cpu_enc, img16.cpu(), p5["enc_spec"], aux=False)["out"].float()
        enc_err = float((card - cpu).abs().max()) / float(cpu.abs().max())
        del img16, card, cpu
    out.update(psnr_bf16_vs_f32_2048_db=db, psnr_bf16_vs_f32_uhd_db=db_uhd,
               e5_2048_card_vs_cpu_rel_err=enc_err)
    log(f"phase 10c: bf16 vs float32 on the card, reflect-tiled photo pair: 2048^2 PSNR "
        f"{db:.2f} dB (min {BF16_PSNR_MIN_DB}), UHD slab {db_uhd:.2f} dB (JAX's bf16 UHD photo "
        f"reading {JAX_BF16_PHOTO_DB} dB); encoder e5 at 2048^2 card vs CPU in bf16 max err / "
        f"max|cpu| {enc_err:.3e} (tol {BF16_STAGE_TOL})")
    if not (db > BF16_PSNR_MIN_DB and enc_err < BF16_STAGE_TOL):
        raise AssertionError(f"phase 10c: bf16 vs f32 {db:.2f} dB, e5 card vs cpu {enc_err}")

    # (d) cli.stylize --bf16 on the card: the bf16 engine's pixels
    with tempfile.TemporaryDirectory() as tmp:
        for sub, img in (("content", c2k), ("style", s2k)):
            os.makedirs(os.path.join(tmp, sub))
            save_image(img, os.path.join(tmp, sub, "p.png"))
        t0 = time.perf_counter()
        _, launches_cli = counted(lambda: cli.main(
            ["--mode", "16x", "--contentPath", os.path.join(tmp, "content"), "--stylePath",
             os.path.join(tmp, "style"), "--outf", os.path.join(tmp, "out"), "--log_mark", "b",
             "--bf16"]))
        out["cli_s"] = time.perf_counter() - t0
        _check_counts("phase 10d: cli.stylize --bf16, one 2048^2 pair", launches_cli,
                      expected(calls16))
        path, _ = jpeg_or_png(os.path.join(tmp, "out", "b_mode=16x_alpha=1.0_p+p.jpg"))
        with open(path, "rb") as f:
            _same_as(f.read(), "image/png" if path.endswith(".png") else "image/jpeg",
                     eng16.stylize(c2k, s2k, as_uint8=True), "phase 10d: cli.stylize --bf16")
    log(f"phase 10d: cli.stylize --bf16 wrote {os.path.basename(path)} in {out['cli_s']:.2f} s: "
        f"the bf16 engine's uint8 pixels")

    table = []
    for k in kc.BF16_KERNELS:
        name = k.__name__
        src, replaces = KERNEL_META[name]
        uhd_only = name == "conv1x1_bias_bf16"
        mine = [r for r in checks if r["kernel"] == name]
        row = {"name": name, "route": "cuda", "source": REPO_PATH + src, "replaces": replaces,
               "launches": (launches16_uhd if uhd_only else launches16)[name],
               "max_abs_err": max(r["max_abs_err"] for r in mine),
               "max_err": max(r["max_abs_err"] for r in mine),
               "max_rel_err": max(r["max_rel_err"] for r in mine),
               "path": "bf16 UHD slab" if uhd_only else "bf16 2048^2 plain",
               **path_times([r for r in (rows_uhd if uhd_only else rows) if r["kernel"] == name])}
        if not uhd_only:
            row["uhd_slab"] = {"launches": launches16_uhd[name],
                               **path_times([r for r in rows_uhd if r["kernel"] == name])}
        table.append(row)
        conv_alone = lambda r: (f", cuDNN bf16 conv alone {r['library_conv_ms']:.3f}"
                                if "library_conv_ms" in r else "")
        log(f"phase 10: {name}: {row['ms']:.3f} ms a {row['path']} cascade over "
            f"{row['launches']} launches, plain {row['plain_ms']:.3f}, library "
            f"{row['library_ms']:.3f}{conv_alone(row)}, bound {row['bound_ms']:.3f} "
            f"({row['bound_by']})"
            + ("" if uhd_only else
               f"; UHD slab {row['uhd_slab']['ms']:.3f} ms over {row['uhd_slab']['launches']}, "
               f"plain {row['uhd_slab']['plain_ms']:.3f}, library "
               f"{row['uhd_slab']['library_ms']:.3f}{conv_alone(row['uhd_slab'])}, bound "
               f"{row['uhd_slab']['bound_ms']:.3f}"))
    out["shapes_timed"] = rows + rows_uhd
    out["phase10_s"] = time.perf_counter() - t10
    log(f"phase 10: {out['phase10_s']:.1f} s")
    return out, table

# (N, H, W, Cin, Cout, relu, sides, offset[, row offset, row pad]) of the
# bf16 halo conv's edge checks (phase 10e): one pixel, one row (N = 2), one
# past the pixel tile of every bf16 template both ways (Cin 3 through
# registers, the wgmma widths 64 and 128), maps off 16-byte alignment (the
# 2-byte staging), a null side, the teachers' streamed weights; and x
# 16-byte aligned with Cin % 8 == 0 (the 16-byte copies' case) where only
# the rows are off: their start (row offset) or, at N = 2, their batch
# stride (row pad)
BF16_HALO_EDGE = [(1, 1, 1, 128, 128, True, "both", 0), (2, 1, 37, 16, 16, True, "both", 1),
                  (1, 33, 33, 3, 16, True, "bot", 1), (1, 17, 33, 3, 24, True, "both", 0),
                  (1, 33, 33, 16, 3, False, "top", 1), (2, 33, 33, 16, 16, True, "both", 0),
                  (1, 17, 33, 16, 32, True, "both", 3), (1, 33, 33, 24, 3, True, "bot", 0),
                  (1, 17, 33, 32, 16, True, "both", 1), (1, 17, 33, 32, 32, False, "top", 0),
                  (1, 17, 17, 64, 64, True, "both", 1), (2, 17, 17, 128, 128, True, "both", 0),
                  (1, 17, 17, 64, 128, True, "bot", 3), (1, 1, 9, 256, 256, True, "both", 1),
                  (1, 17, 33, 16, 16, True, "both", 0, 1, 0),
                  (1, 17, 33, 32, 32, True, "top", 0, 4, 0),
                  (1, 17, 17, 64, 64, True, "bot", 0, 3, 0),
                  (1, 1, 17, 128, 128, True, "both", 0, 1, 0),
                  (2, 17, 33, 24, 24, True, "both", 0, 0, 1),
                  (2, 9, 17, 128, 64, True, "both", 0, 0, 4)]


def bf16_sharded_phase(torch, kc, WCTEngine, bench, eng, eng16, c2k, s2k, c_uhd, c512, s512,
                       calls_sh, layers_sh, margins, f32) -> tuple[dict, dict]:
    """Phases 10e-g (see the module docstring): the bf16 halo conv and the
    halo exchange on bf16 shards against their plain versions, timed; the
    bf16 per-conv, slab-in-shard and photo-WCT engines with every count
    zeroed before and read after, against the bf16 (or float32) cascades
    they stand for, warm beside the float32 medians of this run (``f32``);
    ``cli.stylize --bf16 --space``. Returns the phases' details and the
    sub-rows of the kernel table, ``{kernel name: {key: row}}``."""
    import tempfile

    from collaborative_distillation_tpu_torch.cli import stylize as cli
    from collaborative_distillation_tpu_torch.utils.image import jpeg_or_png, save_image
    t_e = time.perf_counter()
    bf = torch.bfloat16
    pyr, stages = eng.pyramid, eng.stages
    devs = ["cuda:0"] * SHARDS
    pc16 = WCTEngine(mode="16x", dtype=bf, space=SHARDS, devices=devs)
    sh16 = WCTEngine(mode="16x", dtype=bf, space=SHARDS, slab_rows=SHARD_SLAB, devices=devs)
    out: dict = {}

    # (e) the bf16 halo conv at every shape of the per-conv path at
    # PC_AWK_H x 2048 (shards of unequal heights), timed against the same
    # convs reflecting their own rows and torch.cat of the extended shards;
    # edge shapes; photo-WCT's bf16 decoder convs on unpooled maps; the halo
    # exchange on bf16 shards at every (stage, shard) shape of the sharded
    # UHD path, exactly
    awk_rows = pc16._block_rows(PC_AWK_H)
    pc_calls = per_conv_calls(pyr, stages, awk_rows, 2048)
    halo = [{**bench.run("conv3x3_halo_bf16", shape, timed=True, reps=20), "calls": n}
            for (_, shape), n in sorted(pc_calls.items(), key=str)]
    edge = [bench.run("conv3x3_halo_bf16", shape) for shape in BF16_HALO_EDGE]
    # the other bf16 kernels at their own shapes on both sharded paths: the
    # slab-in-shard windows of SHARD_SLAB + 2 * margin rows (conv3x3, pool,
    # upsample, the folded WCT's 1x1), and the per-conv 2048^2 path's
    # shards (pool, upsample, 1x1, the halo convs of shard heights that
    # PC_AWK_H lacks), each within one ulp or exactly
    pc2k = per_conv_path_calls(pyr, stages, pc16._block_rows(2048), 2048, 2048, 2048)
    shard_shapes = {}
    for calls, layers in ((calls_sh, layers_sh), (pc2k, {})):
        for kernel, shape in calls:
            if kernel in BF16_OF:
                shard_shapes.setdefault((BF16_OF[kernel], shape), layers.get(shape))
            elif kernel == "conv3x3_halo" and (kernel, shape) not in pc_calls:
                shard_shapes.setdefault(("conv3x3_halo_bf16", shape), None)
    shard_checks = [bench.run(kernel, shape, layer)
                    for (kernel, shape), layer in sorted(shard_shapes.items(), key=str)]
    unpooled = unpooled_conv_checks(torch, kc, eng16.pyramid, stages, 2048, 2048)
    xch = [{**bench.run(kernel + "_bf16", shape, timed=True), "calls": n}
           for (kernel, shape), n in sorted(calls_sh.items(), key=str)
           if kernel in SHARDED_ONLY]
    per_cascade = lambda key: sum(r[key] * r["calls"] for r in halo)
    halo_t = {"shard_rows": awk_rows, "launches": sum(pc_calls.values()), **path_times(halo),
              **{key: per_cascade(key) for key in ("conv_ms", "reflect_ms", "event_ms",
                                                   "event_conv_ms", "event_reflect_ms",
                                                   "library_device_ms")},
              "max_abs_err": max(r["max_abs_err"] for r in halo + edge)}
    by_kernel = Counter(r["kernel"] for r in shard_checks)
    unpooled_t = {"launches": len(unpooled), **path_times(unpooled),
                  "max_abs_err": max(r["max_abs_err"] for r in unpooled)}
    xch_t = halo_per_cascade(xch, "phase 10e: bf16")
    xch_by = {k: {"launches": sum(r["calls"] for r in xch if r["kernel"] == k + "_bf16"),
                  **path_times([r for r in xch if r["kernel"] == k + "_bf16"]),
                  "max_abs_err": 0.0} for k in SHARDED_ONLY}
    out.update(halo_conv=halo_t, unpooled=unpooled_t, halo_exchange=xch_t,
               halo_edge_shapes=len(edge), halo_conv_shapes=halo,
               sharded_shape_checks={"by_kernel": dict(by_kernel),
                                     "max_rel_err": max(r["max_rel_err"] for r in shard_checks)})
    log(f"phase 10e: bf16 conv3x3 with halo rows at the {len(halo)} shapes of the per-conv "
        f"path at {PC_AWK_H}x2048 (shard rows {awk_rows}) and {len(edge)} edge shapes (one "
        f"row, every bf16 template's ragged tiles, N = 2, rows off 16-byte alignment, Cin 3, "
        f"the wgmma widths, only the rows off 16 bytes): none past one bf16 ulp of the plain "
        f"version; {len(shard_checks)} further shapes of the bf16 sharded paths ("
        f"{', '.join(f'{n} {k}' for k, n in sorted(by_kernel.items()))}; slab-in-shard "
        f"windows, per-conv 2048^2 shards): none past one ulp (pool, upsample exact); a cascade's "
        f"{halo_t['launches']} halo convs {halo_t['conv_ms']:.3f} ms of device time against "
        f"{halo_t['reflect_ms']:.3f} reflecting their own rows: the rows add "
        f"{halo_t['ms']:.3f} ms (by events, host pace included: {halo_t['event_conv_ms']:.3f} "
        f"against {halo_t['event_reflect_ms']:.3f}, {halo_t['event_ms']:.3f}; bound "
        f"{halo_t['bound_ms']:.4f}, plain {halo_t['plain_ms']:.3f}, torch.cat of the extended "
        f"shards {halo_t['library_ms']:.3f} by events, {halo_t['library_device_ms']:.3f} on "
        f"the device); bf16 conv3x3 on "
        f"{len(unpooled)} max-unpooled 2048^2 decoder maps: {unpooled_t['ms']:.3f} ms a cascade "
        f"(bound {unpooled_t['bound_ms']:.3f}, plain {unpooled_t['plain_ms']:.3f}, cuDNN bf16 "
        f"{unpooled_t['library_ms']:.3f}); halo_exchange_rows and halo_fill_rows on bf16 "
        f"shards at the {len(xch)} launch shapes of the sharded UHD path, exact on both "
        f"paths (the per-cascade line above)")

    # (f) the bf16 engines, every count zeroed before and read after
    every = kc.KERNELS + kc.BF16_KERNELS

    def counted(fn):
        _zero(kc)
        r = fn()
        torch.cuda.synchronize()
        return r, {k.__name__: k.launches for k in every}, kc.conv3x3_reflect_bf16.halo_launches

    eng16_cpu = WCTEngine(mode="16x", device="cpu", dtype=bf)
    with torch.inference_mode():
        img16, sty16 = eng16._prep(c2k), eng16._prep(s2k)
        plain16 = eng16.stylize_device(img16, sty16)
        db_ref = psnr_device(torch, plain16, eng.stylize_device(eng._prep(c2k), eng._prep(s2k)))
        pc = {}
        for h in (2048, PC_AWK_H):
            rows = pc16._block_rows(h)
            o, launches, halo_n = counted(lambda: pc16.stylize_device(img16[:, :h], sty16))
            want = bf16_totals(kc, per_conv_path_calls(pyr, stages, rows, 2048, 2048, 2048))
            want_halo = sum(per_conv_calls(pyr, stages, rows, 2048).values())
            _check_counts(f"phase 10f: bf16 per-conv {h}x2048 (shard rows {rows})", launches, want)
            if halo_n != want_halo:
                raise AssertionError(f"phase 10f: bf16 per-conv {h}: {halo_n} halo convs, "
                                     f"predicted {want_halo}")
            ref = plain16 if h == 2048 else eng16.stylize_device(img16[:, :h], sty16)
            pc[h] = {"launches": launches, "halo_launches": halo_n,
                     "psnr_vs_bf16_plain_db": psnr_device(torch, o, ref)}
            del o, ref
        del plain16
        img_u = sh16._prep(c_uhd)
        o, launches_sh, _ = counted(lambda: sh16.stylize_device(img_u, sty16))
        _check_counts(f"phase 10f: bf16 sharded UHD (space={SHARDS}, slab_rows={SHARD_SLAB})",
                      launches_sh, bf16_totals(kc, calls_sh))
        # the sharded path's style statistics come from the unfolded
        # encoders (as the reference's), the single-card slab path's from
        # its folded ones: the two cascades that differ by the order of sums
        # alone are the ones with conv0 run (packed=False); phase 5e holds
        # the folded ones to them
        del o
        o = WCTEngine(mode="16x", dtype=bf, space=SHARDS, slab_rows=SHARD_SLAB, devices=devs,
                      packed=False).stylize_device(img_u, sty16)
        db_sh = psnr_device(torch, o, WCTEngine(mode="16x", dtype=bf, slab_rows=SHARD_SLAB,
                                                packed=False).stylize_device(img_u, sty16))
        del o
        want_pw = {k.__name__: 0 for k in every}
        for name, n in pwct_path_calls(pyr, stages, 2048, 2048).items():
            want_pw[BF16_OF.get(name, name)] += n
        o, launches_pw, _ = counted(lambda: eng16.stylize_device(img16, sty16, pwct=True))
        _check_counts("phase 10f: bf16 stylize(pwct=True) 2048^2", launches_pw, want_pw)
        db_pw = psnr_device(torch, o, eng.stylize_device(eng._prep(c2k), eng._prep(s2k),
                                                         pwct=True))
        del o
    shared = pwct_shared_indices(torch, eng16, eng16_cpu, c512, s512)
    out.update(per_conv={str(h): v for h, v in pc.items()}, bf16_vs_f32_plain_2048_db=db_ref,
               sharded_uhd={"launches": launches_sh, "psnr_vs_bf16_slab_db": db_sh},
               pwct={"launches": launches_pw, "psnr_vs_f32_pwct_db": db_pw,
                     "card_vs_cpu_shared_indices_512": shared})
    log(f"phase 10f: bf16 per-conv (space={SHARDS} on one card) vs the bf16 plain cascade "
        f"2048^2 {pc[2048]['psnr_vs_bf16_plain_db']:.2f} dB, {PC_AWK_H}x2048 "
        f"{pc[PC_AWK_H]['psnr_vs_bf16_plain_db']:.2f} dB (bf16 plain vs float32 plain "
        f"{db_ref:.2f} dB; min {BF16_SHARD_MIN_DB}), halo convs {pc[2048]['halo_launches']} "
        f"and {pc[PC_AWK_H]['halo_launches']}; bf16 sharded UHD vs the bf16 slab cascade at "
        f"slab_rows={SHARD_SLAB}, both packed=False, {db_sh:.2f} dB (min {BF16_SHARD_MIN_DB}); bf16 photo-WCT 2048^2 vs "
        f"float32 photo-WCT {db_pw:.2f} dB (min {BF16_PWCT_MIN_DB}); 512^2 bf16 photo-WCT card "
        f"vs cpu with the card's pool indices: encoders max rel err "
        f"{shared['encoder_max_rel_err']:.3e}, decoders {shared['decoder_max_rel_err']:.3e} "
        f"(tol {BF16_STAGE_TOL}), cascade {shared['psnr_db']:.2f} dB (min {BF16_ORDER_MIN_DB}), "
        f"card side vs stylize(pwct=True) max abs {shared['engine_max_abs']:.3e}")
    if not (min(v["psnr_vs_bf16_plain_db"] for v in pc.values()) >= BF16_SHARD_MIN_DB
            and db_sh >= BF16_SHARD_MIN_DB and db_pw >= BF16_PWCT_MIN_DB
            and max(shared["encoder_max_rel_err"], shared["decoder_max_rel_err"])
            <= BF16_STAGE_TOL and shared["psnr_db"] >= BF16_ORDER_MIN_DB
            and shared["engine_max_abs"] <= CACHE_TOL):
        raise AssertionError(f"phase 10f: per-conv {pc}, sharded {db_sh:.2f} dB, photo-WCT "
                             f"{db_pw:.2f} dB, shared indices {shared}")

    # (f) warm: each bf16 cascade beside the float32 one of this run
    warm = {"per_conv_2048": per_conv_timing(torch, kc, pc16, img16, sty16,
                                             "phase 10f (bf16 per-conv 2048x2048)")}
    warm["per_conv_2048"]["f32_median_ms"] = f32["per_conv"]
    with torch.inference_mode():
        for label, e, img, kw, n in (("sharded_uhd", sh16, img_u, {}, 3),
                                     ("pwct_2048", eng16, img16, {"pwct": True}, 5),
                                     ("pwct_2048_f32", eng, eng._prep(c2k), {"pwct": True}, 5)):
            sty = sty16 if e is not eng else eng._prep(s2k)
            e.stylize_device(img, sty, **kw)   # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated() / 2**30
            runs = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e.stylize_device(img, sty, **kw)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            warm[label] = {"runs_ms": runs, "median_ms": statistics.median(runs),
                           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                           "resident_before_gib": resident,
                           "profile": profile_cascade(torch, e, img, sty, f"phase 10f ({label})",
                                                      **kw)}
            warm[label]["idle_share"] = warm[label]["profile"].get("idle_share")
        del img_u
    warm["sharded_uhd"]["f32_median_ms"] = f32["sharded"]
    warm["pwct_2048"]["f32_median_ms"] = warm["pwct_2048_f32"]["median_ms"]
    out["warm"] = warm
    idle = lambda w: ("not measured" if w.get("idle_share") is None
                      else f"{w['idle_share']:.3f}")
    for label in ("per_conv_2048", "sharded_uhd", "pwct_2048"):
        w = warm[label]
        log(f"phase 10f: bf16 {label} warm {w['median_ms']:.2f} ms (runs "
            f"{', '.join(f'{r:.2f}' for r in w['runs_ms'])}), float32 {w['f32_median_ms']:.2f} "
            f"ms in this run; peak {w['peak_gib']:.2f} GiB ({w['resident_before_gib']:.2f} GiB "
            f"held before it); idle share {idle(w)}")

    # (g) cli.stylize --bf16 --space --slab_rows on one 2048^2 pair, the shards
    # on the one card: the bf16 sharded engine's pixels (without --packed the
    # CLI keeps conv0, as the reference's does: packed=False)
    cli_eng = WCTEngine(mode="16x", dtype=bf, space=SHARDS, slab_rows=SHARD_SLAB, devices=devs,
                        packed=False)
    calls_cli, _ = sharded_path_calls(pyr, stages, margins, cli_eng._tiled_slab, SHARDS, 2048,
                                      2048, 2048, 2048)
    with tempfile.TemporaryDirectory() as tmp:
        for sub, img in (("content", c2k), ("style", s2k)):
            os.makedirs(os.path.join(tmp, sub))
            save_image(img, os.path.join(tmp, sub, "p.png"))
        t0 = time.perf_counter()
        _, launches_cli, _ = counted(lambda: cli.main(
            ["--mode", "16x", "--contentPath", os.path.join(tmp, "content"), "--stylePath",
             os.path.join(tmp, "style"), "--outf", os.path.join(tmp, "out"), "--log_mark", "b",
             "--bf16", "--space", str(SHARDS), "--slab_rows", str(SHARD_SLAB), "--devices",
             ",".join(devs)]))
        out["cli_s"] = time.perf_counter() - t0
        _check_counts(f"phase 10g: cli.stylize --bf16 --space {SHARDS} --slab_rows "
                      f"{SHARD_SLAB}, one 2048^2 pair", launches_cli, bf16_totals(kc, calls_cli))
        path, _ = jpeg_or_png(os.path.join(tmp, "out", "b_mode=16x_alpha=1.0_p+p.jpg"))
        with open(path, "rb") as f:
            _same_as(f.read(), "image/png" if path.endswith(".png") else "image/jpeg",
                     cli_eng.stylize(c2k, s2k, as_uint8=True), "phase 10g: cli.stylize")
    log(f"phase 10g: cli.stylize --bf16 --space {SHARDS} --slab_rows {SHARD_SLAB} wrote "
        f"{os.path.basename(path)} in {out['cli_s']:.2f} s: the bf16 sharded engine's pixels")
    out["phase10efg_s"] = time.perf_counter() - t_e
    in_cascade = halo_in_cascade(warm["sharded_uhd"]["profile"],
                                 sum(launches_sh[k] for k in SHARDED_ONLY))
    log(f"phase 10e-g: {out['phase10efg_s']:.1f} s")
    sub = {"conv3x3_reflect_bf16": {
               "per_conv_halo": {"path": f"bf16 per-conv {PC_AWK_H}x2048, what the rows add",
                                 **halo_t},
               "unpooled": {"path": "bf16 photo-WCT 2048^2 decoders, unpooled maps",
                            **unpooled_t}},
           **{k: {"bf16_sharded": {"path": "bf16 UHD sharded",
                                   "launches_counted": launches_sh[k], **xch_by[k],
                                   "in_cascade_ms": in_cascade[k]}}
              for k in SHARDED_ONLY}}
    return out, sub


def main() -> int:
    global PEAK_FP32_FLOPS, PEAK_BF16_FLOPS
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    from collaborative_distillation_tpu_torch.utils.flops import card_peak_flops, cascade_flops
    PEAK_FP32_FLOPS, peak_label = card_peak_flops(0, "float32")
    PEAK_BF16_FLOPS = card_peak_flops(0, "bfloat16")[0]
    if not (PEAK_FP32_FLOPS and PEAK_BF16_FLOPS):
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
    import threading

    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    t0 = time.perf_counter()
    nvjpeg_s: list = []   # the nvJPEG shim builds beside the kernels
    nvjpeg_thread = threading.Thread(
        target=lambda: (nj.available(), nvjpeg_s.append(time.perf_counter() - t0)))
    nvjpeg_thread.start()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(built={_build.last_build['built']}, {_build.last_build['dir']})")
    nvjpeg_thread.join()
    for line in _build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())
    detail["card"] = smi
    detail["build_s"] = _build.last_build["seconds"]
    detail["nvjpeg"] = nvjpeg_presence()
    detail["nvjpeg_load"] = nvjpeg_load(nj, nvjpeg_s[0])

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
    # the same path one shard a card where there are several (cross_card's
    # spread): one exchange and one fill a stage on each card
    calls_x, _ = sharded_path_calls(pyr, eng.stages, cas.margins, shard_eng._tiled_slab,
                                    SHARDS, UHD_H, UHD_W, 2048, 2048,
                                    devices=[f"cuda:{i % torch.cuda.device_count()}"
                                             for i in range(SHARDS)])
    names = [k.__name__ for k in kc.KERNELS]
    if "--cross-card" in sys.argv[1:]:
        # only what exists across cards: needs two or more, prints no kernel table
        if torch.cuda.device_count() < 2:
            print("chip_smoke --cross-card: needs two or more CUDA devices", file=sys.stderr)
            return 1
        import tempfile
        if "--dp" not in sys.argv[1:]:
            detail["cross_card"] = cross_card(torch, kc, WCTEngine, bench, c_uhd, c2k, s2k,
                                              calls_x)
        with tempfile.TemporaryDirectory() as tmp:
            detail["data_parallel"] = dp_cross_card(torch, kc, c512, s512, tmp)
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
    # neighbour, N = 2, W*C not a multiple of 4, shards at odd offsets; and
    # with k shards of one launch instead of a position, the exchange and
    # the fill (two to five shards, the same edges)
    edge += [("halo_exchange_rows", s) for s in
             [(1, 8, 16, 8, 1, "mid", 0), (1, 8, 16, 8, 8, "mid", 0), (2, 8, 16, 8, 2, "mid", 0),
              (1, 6, 5, 3, 2, "mid", 0), (2, 6, 5, 3, 3, "first", 1), (1, 4, 7, 1, 1, "last", 3),
              (2, 64, 33, 3, 32, "mid", 2), (1, 1, 9, 4, 1, "mid", 0)]]
    edge += [(kernel, s) for kernel in SHARDED_ONLY for s in
             [(1, 8, 16, 8, 1, 3, 0), (1, 8, 16, 8, 8, 2, 0), (2, 8, 16, 8, 2, 4, 0),
              (2, 6, 5, 3, 3, 3, 1), (1, 4, 7, 1, 1, 5, 3), (2, 64, 33, 3, 32, 2, 2),
              (1, 1, 9, 4, 1, 2, 0), (1, 96, 2048, 3, 40, 4, 0)]]
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
    n_halo = sum(kernel in SHARDED_ONLY for kernel, _ in only_sh)
    log(f"phase 2: {len(checks)} kernel-vs-plain checks passed at the 512^2 path, edge, "
        f"all {len(calls_uhd)} UHD slab path, the plain UHD {biggest} and the "
        f"{len(only_sh)} further sharded UHD path shapes ({n_halo} of the halo, exact; "
        f"UHD ones in {time.perf_counter() - t0:.1f} s)")
    # the per-conv sharded path at 2000 rows: shards of unequal heights (whole
    # 16-row blocks, the remainder on the last), every conv staging its
    # neighbours' rows, timed against the same conv reflecting its own (row
    # 8a); edge shapes of the halo conv; and photo-WCT's decoder convs on
    # max-unpooled maps (3 of 4 values 0)
    awk_rows = per_conv._block_rows(PC_AWK_H)
    pc_calls = per_conv_calls(pyr, eng.stages, awk_rows, 2048)
    pc_rows = []
    for (kernel, shape), n in sorted(pc_calls.items(), key=str):
        pc_rows.append({**bench.run(kernel, shape, timed=True, reps=20), "calls": n})
    # (N, H, W, Cin, Cout, relu, sides, float offset): H = 1, ragged tiles of
    # every template, N = 2, rows off 16-byte alignment, a null side
    halo_edge = [bench.run("conv3x3_halo", s) for s in
                 [(1, 1, 1, 128, 128, True, "both", 0), (2, 1, 37, 16, 16, True, "both", 1),
                  (1, 9, 17, 128, 128, True, "bot", 1), (1, 17, 17, 64, 64, True, "top", 3),
                  (2, 17, 33, 32, 32, False, "both", 1), (1, 17, 33, 3, 24, True, "bot", 1),
                  (1, 33, 33, 16, 16, True, "both", 2), (1, 33, 65, 16, 3, False, "top", 1),
                  (1, 33, 65, 24, 3, True, "both", 0), (2, 2, 13, 16, 16, True, "both", 0),
                  (1, 37, 45, 64, 128, True, "both", 1), (1, 16, 16, 256, 24, True, "both", 1),
                  (2, 5, 7, 5, 7, True, "top", 0), (1, 1, 9, 512, 512, True, "both", 0)]]
    unpooled = unpooled_conv_checks(torch, kc, pyr, eng.stages, 2048, 2048)
    checks += pc_rows + halo_edge + unpooled
    # the teachers' widths (Cin or Cout 256/512), the Cout-walking ring: every
    # such conv shape of a wct_se step at stage 5 x 16 x 256^2 (phase 8d) and
    # of the mode-original cascade at 512^2 and ORIGINAL_HW^2 (phase 7f); halo
    # rows at their pairs (ragged tiles, rows off 16-byte alignment)
    from collaborative_distillation_tpu_torch.ops.cuda.conv import device_plan
    wide = sorted({s for s in [*train_conv_calls("wct_se"), *original_conv_calls(512),
                               *original_conv_calls(ORIGINAL_HW)] if teacher_width(s)})
    t_rows = [{**bench.run("conv3x3_reflect", s), "plan": device_plan(*s[:5], 0).kernel}
              for s in wide]
    t_halo = [bench.run("conv3x3_halo", s) for s in
              [(2, 9, 17, 256, 512, True, "both", 1), (1, 17, 33, 512, 512, True, "top", 0),
               (16, 16, 16, 512, 256, True, "both", 0), (1, 33, 17, 256, 128, True, "bot", 3),
               (2, 16, 16, 128, 256, True, "both", 0), (1, 1, 5, 256, 256, True, "both", 1)]]
    checks += t_rows + t_halo
    detail["teacher_width_checks"] = {
        "shapes": len(t_rows), "halo_shapes": len(t_halo),
        "plans": dict(Counter(r["plan"] for r in t_rows)),
        "max_rel_err": max(r["max_rel_err"] for r in t_rows + t_halo)}
    tw = detail["teacher_width_checks"]
    log(f"phase 2: conv3x3 at the teachers' widths: {tw['shapes']} shapes of the wct_se step "
        f"and the original 512^2 and {ORIGINAL_HW}^2 cascades (plans {tw['plans']}) and "
        f"{tw['halo_shapes']} with halo rows, max rel err {tw['max_rel_err']:.3e} (tol "
        f"{CONV_TOL})")
    if "first" in tw["plans"]:
        raise AssertionError(f"phase 2: a teacher-width conv plans the first kernel: {tw}")
    detail["conv3x3_sha256_2048"] = conv3x3_sha256(torch, kc, calls2k)
    log(f"phase 2: SHA-256 of the conv3x3 outputs at the 2048^2 path's "
        f"{sum(k == 'conv3x3_reflect' for k, _ in calls2k)} shapes (seeded inputs): "
        f"{detail['conv3x3_sha256_2048']}")
    detail["per_conv_awkward_halo"] = {"shard_rows": awk_rows, "launches": sum(pc_calls.values()),
                                       **path_times(pc_rows),
                                       "conv_ms": sum(r["conv_ms"] * r["calls"] for r in pc_rows),
                                       "reflect_ms": sum(r["reflect_ms"] * r["calls"]
                                                         for r in pc_rows)}
    detail["unpooled_conv3x3"] = {"launches": len(unpooled), **path_times(unpooled)}
    pc = detail["per_conv_awkward_halo"]
    log(f"phase 2: the per-conv sharded path at {PC_AWK_H}x2048 (shard rows {awk_rows}): "
        f"{len(pc_rows)} halo conv shapes and {len(halo_edge)} edge ones, max rel err "
        f"{max(r['max_rel_err'] for r in pc_rows + halo_edge):.3e} (tol {CONV_TOL}); a "
        f"cascade's {pc['launches']} halo convs {pc['conv_ms']:.3f} ms against "
        f"{pc['reflect_ms']:.3f} reflecting their own rows: the rows add {pc['ms']:.3f} ms "
        f"(bound {pc['bound_ms']:.4f}, plain {pc['plain_ms']:.3f}, torch.cat of the "
        f"extended shards {pc['library_ms']:.3f}); conv3x3 on "
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
                                         if n not in SHARDED_ONLY):
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
        detail["cross_card"] = cross_card(torch, kc, WCTEngine, bench, c_uhd, c2k, s2k, calls_x)
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
        # the per-conv path: every conv stages its halo rows itself, so it
        # launches no exchange; rows past a multiple of 16 * space, in the
        # content and in the style: whole 16-row blocks, the style's
        # statistics taken whole
        pc_out, pc_counts = per_conv_run(kc, per_conv, img2k, sty2k)
        db_pc = psnr_device(torch, pc_out, eng.stylize_device(img2k, sty2k))
        pc_out, awk_counts = per_conv_run(kc, per_conv, img2k[:, :PC_AWK_H], sty2k)
        db_awk_c = psnr_device(torch, pc_out, eng.stylize_device(img2k[:, :PC_AWK_H], sty2k))
        pc_out, awk_s_counts = per_conv_run(kc, per_conv, img2k, sty2k[:, :PC_AWK_H])
        db_awk_s = psnr_device(torch, pc_out, eng.stylize_device(img2k, sty2k[:, :PC_AWK_H]))
        del pc_out
    # one halo conv per conv of the content's encoder and the decoder, and shard
    pc_expect = {"halo_exchange_rows": 0, "halo_fill_rows": 0, "conv3x3_halo": sum(
        per_conv_calls(pyr, eng.stages, [2048 // SHARDS] * SHARDS, 2048).values())}
    awk_expect = {"halo_exchange_rows": 0, "halo_fill_rows": 0, "conv3x3_halo": sum(per_conv_calls(
        pyr, eng.stages, per_conv._block_rows(PC_AWK_H), 2048).values())}
    log(f"phase 4c: UHD sharded (space={SHARDS}, slab_rows={SHARD_SLAB}) vs the single-card "
        f"slab cascade at the same slab size PSNR {db_sh:.2f} dB; 2048^2 per-conv sharded "
        f"vs plain {db_pc:.2f} dB; {PC_AWK_H}x2048 content {db_awk_c:.2f} dB, {PC_AWK_H}x2048 "
        f"style {db_awk_s:.2f} dB (min {PSNR_MIN_DB}); per-conv launches at 2048^2 "
        f"{pc_counts}, {PC_AWK_H}x2048 content {awk_counts}, style {awk_s_counts}, "
        f"predicted {pc_expect}, {awk_expect}, {pc_expect}")
    detail["sharded_vs_single"] = {"uhd_psnr_db": db_sh, "per_conv_2048_psnr_db": db_pc,
                                   "per_conv_launches": pc_counts,
                                   "per_conv_awkward_content_launches": awk_counts,
                                   "per_conv_awkward_style_launches": awk_s_counts,
                                   "per_conv_awkward_content_psnr_db": db_awk_c,
                                   "per_conv_awkward_style_psnr_db": db_awk_s}
    if not (min(db_sh, db_pc, db_awk_c, db_awk_s) >= PSNR_MIN_DB and pc_counts == pc_expect
            and awk_counts == awk_expect and awk_s_counts == pc_expect):
        raise AssertionError(f"sharded vs single-card: UHD {db_sh:.2f} dB, per-conv "
                             f"{db_pc:.2f} / {db_awk_c:.2f} / {db_awk_s:.2f} dB, launches "
                             f"{pc_counts}, {awk_counts}, {awk_s_counts} != {pc_expect}, "
                             f"{awk_expect}, {pc_expect}")

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
    # the halo exchange and fill lie on the sharded UHD path only
    for (kernel, shape), n in sorted(calls_sh.items(), key=str):
        if kernel in SHARDED_ONLY:
            r = bench.run(kernel, shape, timed=True)
            r["calls"] = n
            rows.append(r)
    path_launches = {**launches, "conv1x1_bias": launches_uhd["conv1x1_bias"],
                     **{k: launches_sh[k] for k in SHARDED_ONLY}}
    detail["halo_per_cascade"] = halo_per_cascade(
        [r for r in rows if r["kernel"] in SHARDED_ONLY], "phase 5c: float32")
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
        mine = [r for r in checks + rows if KERNEL_OF.get(r["kernel"], r["kernel"]) == name]
        errs = [r["max_abs_err"] for r in mine]
        rel = [r["max_rel_err"] for r in mine]
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
    for name, ms in halo_in_cascade(detail["profile_sharded"],
                                    sum(launches_sh[k] for k in SHARDED_ONLY)).items():
        next(r for r in table if r["name"] == name)["in_cascade_ms"] = ms
        log(f"phase 5c: {name} in the profiled cascade: "
            + ("not measured" if ms is None else f"{ms:.4f} ms of device time"))
    # ---- phase 5d: the warm per-conv sharded cascade -----------------------------
    detail["per_conv_timed"] = [per_conv_timing(torch, kc, per_conv, img2k[:, :h], sty2k,
                                                f"phase 5d ({h}x2048)")
                                for h in (2048, PC_AWK_H)]
    # ---- phase 5e: packed (conv0 folded into conv1_1) against packed=False -------
    detail["packed"] = packed_phase(torch, kc, WCTEngine, c_uhd, s2k, smi)
    detail["host_boundary"] = host_boundary(torch, kc, slab_eng, eng, c_uhd, c2k, s2k,
                                            expect_uhd)
    # ---- phase 10: bf16 inference ------------------------------------------------
    detail["bf16"], table_bf16 = bf16_phase(
        torch, kc, WCTEngine, bench, eng, slab_eng, c2k, s2k, c_uhd, calls2k, layers2k,
        calls_uhd, layers_uhd, {"2048": detail["cascade_2048_ms"]["median"],
                                "uhd": detail["cascade_uhd_ms"]["median"]})
    table += table_bf16
    detail["bf16_sharded"], sub_rows = bf16_sharded_phase(
        torch, kc, WCTEngine, bench, eng, WCTEngine(mode="16x", dtype=torch.bfloat16), c2k,
        s2k, c_uhd, c512, s512, calls_sh, layers_sh, cas.margins,
        {"per_conv": detail["per_conv_timed"][0]["median_ms"],
         "sharded": detail["cascade_sharded_ms"]["median"]})
    for name, extra in sub_rows.items():
        next(r for r in table if r["name"] == name).update(extra)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        # ---- phase 9: photo-WCT, the cascade function, the teacher store ---------
        t9 = time.perf_counter()
        detail["photo_wct"] = photo_wct(torch, kc, eng, eng_cpu, slab_eng, shard_eng, c2k, s2k,
                                        c512, s512)
        detail["cascade_fn"] = cascade_fn_check(torch, eng, c2k, s2k)
        detail["teacher_store"] = teacher_store(torch, tmp)
        detail["small_modules"] = small_modules(torch, eng, c512)
        detail["asset_tools"] = asset_tools(torch, kc, c512, s512, c2k, s2k, tmp,
                                            detail["teacher_store"]["root"])
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
    # the bf16 rows also carry the bf16 training steps: 8e(d)'s sums per mode
    for name, by_mode in detail["training"]["bf16"]["kernel_times"].items():
        if name != "shapes":
            next(r for r in table if r["name"] == name)["bf16_training"] = {
                "path": f"bf16 step, stage {TRAIN_STAGE} x {TRAIN_N} x {TRAIN_HW}^2", **by_mode}
    # conv3x3's row also carries the teachers' widths: 8d's sums over a
    # wct_se step, and the launches of one warm original cascade (7f)
    tc = detail["training"]["teacher_convs"]
    next(r for r in table if r["name"] == "conv3x3_reflect")["teacher_widths"] = {
        **{k: tc[k] for k in ("launches", "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")},
        "path": f"wct_se step, stage {TRAIN_STAGE} x {TRAIN_N} x {TRAIN_HW}^2",
        "original_cascade_launches": detail["teacher_widths"]["cascade"]["conv3x3_by_template"]}
    # the training loader's resize kernels (phase 8g), no TPU kernel's
    # counterparts: launches from the float32 JPEG folder's cli.train run,
    # times summed over a training batch of the folder's files
    jp = detail["training"]["jpeg"]
    for k in kc.DATA_KERNELS:
        name = k.__name__
        src, rep = DATA_META[name]
        r = jp["kernels"]["rows"][name]
        table.append({"name": name, "route": "cuda", "source": REPO_PATH + src, "replaces": rep,
                      "launches": jp["cli"]["jpeg_f32"]["launches"][name],
                      "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
                      "max_rel_err": r["max_abs_err"] / 255,
                      "path": f"cli.train on a JPEG folder, a batch of {TRAIN_N}",
                      **r["per_batch"]})
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
