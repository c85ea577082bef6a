#!/usr/bin/env python3
"""Time conv3x3 at the teachers' widths (Cin or Cout 256/512) of one checkout.

For the checkout at ``--root`` (default: this one) it prints one JSON line:

* ``teacher_convs``: ``chip_smoke.teacher_conv_times`` (phase 8d): the 27
  teacher-width convs of a wct_se step at stage 5 x 16 x 256^2 against the
  plain version, cuDNN's FP32 forward and the bound, with their plans;
* ``train``: a ``Trainer`` step of wct_se, wct_sd_kd2sd and wct_sd at stage
  5 x 16 x 256^2 on one seeded batch (teachers and students from
  ``torch.Generator`` seed 0): the median of steps 2-6 (host clock around a
  synchronised step), peak memory, and one profiled step's busy split into
  the hand-written kernels, cuDNN's backward, cuBLAS and the rest;
* ``original``: ``chip_smoke.original_cascade`` (phase 7f), the warm
  mode-original cascade at 1024^2 on a seeded pyramid: median of 3, peak;
* ``conv3x3_sha256``: ``chip_smoke.conv3x3_sha256`` at the 2048^2 mode-16x
  path's conv shapes, equal across checkouts whose kernels compute the
  same bits there;
* ``ptxas``: the register and spill lines of the conv3x3 kernels.

The timing functions are this checkout's ``chip_smoke.py``; the package and
the kernels are ``--root``'s. So two versions are compared on one card in
turns, parent, change, change, parent, with the parent unpacked under the
ignored ``build/checkouts/`` (``git archive``):

    python3 tools/bench_teacher.py --root build/checkouts/parent [--skip train]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("teacher_convs", "train", "original", "sha256")
TRAIN_MODES = ("wct_se", "wct_sd_kd2sd", "wct_sd")
TRAIN_STEPS = 6   # the median is over steps 2..6


def train_steps(torch, cs, mode: str) -> dict:
    """A seeded stage-5 ``Trainer`` of ``mode``, TRAIN_STEPS steps on one
    batch: the median step of 2..TRAIN_STEPS, peak memory, a profiled step."""
    import numpy as np

    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    from collaborative_distillation_tpu_torch.models.vgg import init_params
    from collaborative_distillation_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                                    student_spec)
    k = cs.TRAIN_STAGE
    gen = torch.Generator().manual_seed(0)
    frozen = {"be": init_params(encoder_spec("original", k), gen),
              "bd": init_params(decoder_spec("original", k), gen),
              "se": init_params(encoder_spec("16x", k, aux=True), gen)}
    cfg = TrainConfig(mode=mode, stage=k)
    trainer = Trainer(cfg, init_params(student_spec(cfg), gen), frozen, device="cuda")
    batch = torch.from_numpy(np.random.default_rng(0).random(
        (cs.TRAIN_N, cs.TRAIN_HW, cs.TRAIN_HW, 3), dtype=np.float32)).cuda()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return {"step_ms": statistics.median(steps[1:]), "steps_ms": steps, "peak_gib": peak,
            **cs._profile_step(torch, trainer, batch)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--skip", nargs="*", default=[], choices=PARTS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_teacher: needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from collaborative_distillation_tpu_torch.ops import cuda as kc
    from collaborative_distillation_tpu_torch.ops.cuda import _build
    from collaborative_distillation_tpu_torch.utils.flops import card_peak_flops
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    cs.PEAK_FP32_FLOPS = card_peak_flops(0, "float32")[0]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    ptxas, entry = [], ""
    for line in _build.last_build["log"].splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "conv3x3" in entry and ("registers" in line or "spill" in line):
            ptxas.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    out = {"root": root, "card": card, "ptxas": ptxas}
    if "teacher_convs" not in args.skip:
        tc = cs.teacher_conv_times(torch)
        out["teacher_convs"] = {k: v for k, v in tc.items() if k != "shapes"}
        out["teacher_convs"]["shapes"] = [
            {k: r[k] for k in ("shape", "calls", "plan", "ms", "plain_ms", "library_ms",
                               "bytes_ms", "flops_ms", "max_rel_err")} for r in tc["shapes"]]
    if "train" not in args.skip:
        out["train"] = {m: train_steps(torch, cs, m) for m in TRAIN_MODES}
    if "original" not in args.skip:
        import numpy as np
        with np.load(os.path.join(root, "collaborative_distillation_tpu_torch", "data",
                                  "photo_pair_512.npz")) as d:
            c512, s512 = d["content"], d["style"]
        with tempfile.TemporaryDirectory() as tmp:
            cs.write_original_weights(torch, tmp)
            teng = WCTEngine(mode="original", weights_root=tmp)
            out["original"] = cs.original_cascade(torch, teng, c512, s512)
    if "sha256" not in args.skip:
        from collaborative_distillation_tpu_torch.models.zoo import stage_specs
        stages = (5, 4, 3, 2, 1)
        pyr = {k: dict(zip(("enc_spec", "dec_spec"), stage_specs("16x", k))) for k in stages}
        calls, _ = cs.path_calls(pyr, stages, 2048, 2048)
        out["conv3x3_sha256"] = cs.conv3x3_sha256(torch, kc, calls)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
