#!/usr/bin/env python3
"""Where the card's JPEG training loader spends its time, on one card.

Writes a folder of ``--files`` nvJPEG q95 JPEGs in ``chip_smoke.py`` phase
8g's mix (480x640 to 2500x3300, every other one portrait) and prints one
JSON line:

* ``decode_ms``: one thread, warm, per file size: nvJPEG's whole decode
  alone and the whole training decode (``jpeg.decode_jpeg_shorter_side``
  on the card, then ``fetch``), medians of 5, synchronised;
* ``loader``: ``Loader(ImageFolderDataset(device="cuda", uint8=True), 16,
  num_workers=--workers)`` over the folder, one epoch a condition, images/s
  over batches 3 to the last (the pool's start and the first batches left out),
  and the consumer's wait for each batch, while the consumer does, after
  each batch: ``idle`` nothing; ``gpu`` a sleep kernel of ``--step_ms`` on
  the card's default stream, awaited (the device busy, the host free);
  ``gil`` a Python loop of ``--step_ms`` (the host's interpreter busy, the
  device free); ``train_f32`` and ``train_bf16`` a seeded wct_se
  ``Trainer`` step at stage 5 x 16 x 256^2 on the batch (both busy). A
  loader that keeps up gives each busy condition 16 / its step, and waits
  ~0 for a batch; ``alone_f32`` and ``alone_bf16``: the same steps on one
  batch with no loader running (what the loader's threads cost the step);
* ``nvjpeg_memory``: nvJPEG's own bytes at the end.

    python3 tools/bench_train_jpeg.py [--step_ms 100] [--files 192] [--workers 8]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--step_ms", type=float, default=100.0,
                    help="the consumer's work after each batch in the gpu and gil conditions")
    ap.add_argument("--files", type=int, default=192, help="files in the folder (12 batches)")
    ap.add_argument("--workers", type=int, default=8, help="the Loader's decode threads")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_train_jpeg: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from collaborative_distillation_tpu_torch.data import jpeg
    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    from collaborative_distillation_tpu_torch.data.pipeline import ImageFolderDataset, Loader
    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    from collaborative_distillation_tpu_torch.models.vgg import init_params
    from collaborative_distillation_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                                    student_spec)
    from collaborative_distillation_tpu_torch.utils.transfer import fetch
    if not nj.available():
        print(f"bench_train_jpeg: {nj.unavailable_reason()}", file=sys.stderr)
        return 1
    with np.load(os.path.join(HERE, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c512, s512 = d["content"], d["style"]
    k = cs.TRAIN_STAGE
    gen = torch.Generator().manual_seed(0)
    frozen = {"be": init_params(encoder_spec("original", k), gen),
              "bd": init_params(decoder_spec("original", k), gen),
              "se": init_params(encoder_spec("16x", k, aux=True), gen)}
    trainers = {}
    for dtype in ("float32", "bfloat16"):
        cfg = TrainConfig(mode="wct_se", stage=k, compute_dtype=dtype)
        trainers[dtype] = Trainer(cfg, init_params(student_spec(cfg), gen), frozen,
                                  device="cuda")
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(100_000_000)
    b.record()
    torch.cuda.synchronize()
    cycles = int(100_000_000 * args.step_ms / a.elapsed_time(b))   # the card's clock

    def spin():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < args.step_ms / 1e3:
            pass

    def sleep():
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()

    def step(dtype):
        def run(batch):
            trainers[dtype].train_step(batch)
            torch.cuda.synchronize()
        return run

    work = {"idle": lambda batch: None, "gpu": lambda batch: sleep(),
            "gil": lambda batch: spin(), "train_f32": step("float32"),
            "train_bf16": step("bfloat16")}
    out = {"card": torch.cuda.get_device_name(0), "step_ms": args.step_ms, "files": args.files,
           "workers": args.workers}
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "jpegs")
        files = cs.write_training_jpegs(torch, c512, s512, folder,
                                        cs.jpeg_train_sizes(args.files))
        ds = ImageFolderDataset(folder, cs.JPEG_TRAIN_SIDE, cs.TRAIN_HW, uint8=True,
                                device="cuda")
        # one epoch to warm every nvJPEG state and both steps
        for batch, _ in Loader(ds, cs.TRAIN_N, num_workers=args.workers, seed=0):
            step("float32")(batch)
            step("bfloat16")(batch)
        out["loader"] = {}
        for label, fn in work.items():
            ends, waits, t = [], [], time.perf_counter()
            for batch, _ in Loader(ds, cs.TRAIN_N, num_workers=args.workers, seed=1):
                waits.append((time.perf_counter() - t) * 1e3)
                fn(batch)
                t = time.perf_counter()
                ends.append(t)
            n = len(ends) - 3
            out["loader"][label] = {"images_per_s": n * cs.TRAIN_N / (ends[-1] - ends[2]),
                                    "wait_ms": waits,
                                    "median_wait_ms": statistics.median(waits[3:])}
        for dtype, label in (("float32", "alone_f32"), ("bfloat16", "alone_bf16")):
            ends = [time.perf_counter()]
            for _ in range(len(ds) // cs.TRAIN_N):
                step(dtype)(batch)
                ends.append(time.perf_counter())
            out["loader"][label] = {"images_per_s": (len(ends) - 3) * cs.TRAIN_N
                                    / (ends[-1] - ends[2])}
        out["nvjpeg_memory"] = nj.memory()
        per_size = {}
        for path, (h, w) in files.items():
            key = f"{max(h, w)}x{min(h, w)}"
            if key in per_size:
                continue
            with open(path, "rb") as f:
                data = f.read()

            def timed(fn) -> float:
                runs = []
                for _ in range(6):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    runs.append((time.perf_counter() - t0) * 1e3)
                return statistics.median(runs[1:])

            per_size[key] = {
                "nvjpeg_ms": timed(lambda: nj.decode_jpeg(data)),
                "train_decode_ms": timed(lambda: fetch(jpeg.decode_jpeg_shorter_side(
                    data, cs.JPEG_TRAIN_SIDE, "cuda"))),
                "bytes": len(data)}
        out["decode_ms"] = per_size
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
