#!/usr/bin/env python3
"""Time the bf16 conv3x3's halo instantiation without halo rows, and read
what the bf16 per-conv cascade's gate sees when the rows are ignored.

The bf16 ring kernel (``ops/cuda/csrc/bf16_igemm.cuh``) has a template flag
``HALO``: a launch with halo rows runs ``bf16_ring_kernel<R, true>``, one
without them ``bf16_ring_kernel<R, false>``, which carries no halo code.
With null rows the halo instantiation computes what the other one computes
(its staging reflects where a row is null). This script builds
``csrc/conv3x3_bf16.cu`` twice more, from rewritten copies of the sources
in the ignored ``build/`` (the checkout's sources are not touched): once
with every launch sent to the halo instantiation, once with every launch
sent to the one without HALO, so that given rows are ignored and each
shard reflects its own. With the first, at every conv3x3 shape of the bf16
2048^2 plain cascade and of the bf16 UHD slab cascade
(``chip_smoke.path_calls``, ``chip_smoke.slab_path_calls``), it

* checks that both instantiations give the same bits (null rows, random
  bf16 inputs);
* times both with the profiler's device time (``chip_smoke.device_ms``),
  in turns plain, halo, halo, plain, both called straight through ctypes
  with the same launch plan, so that the host's pace counts in neither;
* sums each over a cascade's calls, and gives the two plain readings'
  difference as the noise.

With the second it runs the bf16 per-conv cascade (``space=4`` on
``cuda:0``, the photo pair reflect-tiled to 2048^2) and prints its PSNR
against the bf16 plain cascade, beside the same with the package's kernel:
what ``chip_smoke.py`` phase 10f holds to ``BF16_SHARD_MIN_DB``.

It prints one JSON line (also written to ``chiprun_out/bench_bf16_halo_flag.json``)
with the card's name and power limit and the ptxas register and spill lines
of both instantiations of every template:

    python3 tools/bench_bf16_halo_flag.py [--reps 10]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the launch in csrc/conv3x3_bf16.cu:run that picks the instantiation
PICK = ("  if (a.top || a.bot) return cd_bf16::launch<R, true>(a, grid, s);\n"
        "  return cd_bf16::launch<R>(a, grid, s);\n")
ALWAYS = "  return cd_bf16::launch<R, true>(a, grid, s);\n"
NEVER = "  return cd_bf16::launch<R>(a, grid, s);\n"


def build_variant(_build, launch: str) -> tuple[ctypes.CDLL, str]:
    """conv3x3_bf16.cu with ``launch`` in place of the line pair that picks
    the instantiation, built with the package's flags; the library and its
    compiler log."""
    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    out = os.path.join(HERE, "build", "torch_kernels")
    os.makedirs(out, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="bf16_halo_variant_", dir=out)
    for name in os.listdir(csrc):
        with open(os.path.join(csrc, name)) as f:
            text = f.read()
        if name == "conv3x3_bf16.cu":
            if text.count(PICK) != 1:
                raise RuntimeError("conv3x3_bf16.cu: the launch that picks the instantiation "
                                   "is not where this script expects it")
            text = text.replace(PICK, launch)
        with open(os.path.join(tmp, name), "w") as f:
            f.write(text)
    so = os.path.join(tmp, "libconv3x3_bf16.so")
    p = subprocess.run([_build._nvcc(), *_build._ARCH, *_build._FLAGS, "-shared",
                        os.path.join(tmp, "conv3x3_bf16.cu"), "-o", so],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError("nvcc failed:\n" + p.stdout + p.stderr)
    lib = ctypes.CDLL(so)
    fn = lib.cd_conv3x3_reflect_bf16
    fn.argtypes = _build._SIGNATURES["cd_conv3x3_reflect_bf16"]
    fn.restype = ctypes.c_int
    return lib, p.stdout + p.stderr


class _Swap:
    """The package's kernel library with ``cd_conv3x3_reflect_bf16`` taken
    from another build (what ``_build.library()`` returns while set)."""

    def __init__(self, lib, conv):
        self._lib = lib
        self.cd_conv3x3_reflect_bf16 = conv.cd_conv3x3_reflect_bf16

    def __getattr__(self, name):
        return getattr(self._lib, name)


def ring_ptxas(log: str) -> dict:
    """{demangled-ish bf16 3x3 instantiation: [ptxas register/spill lines]}."""
    out, entry = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "bf16_ring_kernel" in entry and "RingILi9E" in entry and (
                "registers" in line or "spill" in line):
            key = re.sub(r"^.*RingILi9E", "Ring<9,", entry)
            out.setdefault(key, []).append(line.split(":", 1)[-1].strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_bf16_halo_flag: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from collaborative_distillation_tpu_torch.ops.cuda import _build
    from collaborative_distillation_tpu_torch.ops.cuda import conv as kconv
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    from collaborative_distillation_tpu_torch.wct.slab import FEATURE_CACHE_BYTES
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    plain_lib = _build.library()
    halo_lib, halo_log = build_variant(_build, ALWAYS)
    never_lib, _ = build_variant(_build, NEVER)
    eng = WCTEngine(mode="16x")
    slab = WCTEngine(mode="16x", slab_rows=cs.UHD_SLAB).slab
    paths = {"plain_2048": cs.path_calls(eng.pyramid, eng.stages, 2048, 2048)[0],
             "uhd_slab": cs.slab_path_calls(eng.pyramid, eng.stages, slab.margins,
                                            slab.slab_rows, cs.UHD_H, cs.UHD_W, 2048, 2048,
                                            FEATURE_CACHE_BYTES)[0]}
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    result = {"card": card, "reps": args.reps, "paths": {}}
    with torch.no_grad():
        for label, calls in paths.items():
            rows, sums = [], {"plain_ms": 0.0, "halo_ms": 0.0, "plain_again_ms": 0.0,
                              "halo_again_ms": 0.0}
            for (kernel, shape), n_calls in sorted(calls.items(), key=str):
                if kernel != "conv3x3_reflect":
                    continue
                n, h, w, ci, co, relu = shape[:6]
                x = (torch.rand((n, h, w, ci), generator=gen, device="cuda") - 0.5).to(bf)
                wt = ((torch.rand((3, 3, ci, co), generator=gen, device="cuda") - 0.5)
                      * (2 / (9 * ci) ** 0.5)).to(bf)
                b = (torch.rand((co,), generator=gen, device="cuda") - 0.5).to(bf)
                plan = kconv.device_plan_bf16(n, h, w, ci, co, 0)
                stream = torch.cuda.current_stream().cuda_stream

                def launch(lib, y):
                    err = lib.cd_conv3x3_reflect_bf16(
                        x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(), None, None,
                        0, 0, n, h, w, ci, co, int(relu), 1, plan.template, plan.grid[0],
                        int(plan.resident), stream)
                    _build.check(err, f"conv3x3_reflect_bf16{shape}")

                y0, y1 = (torch.empty((n, h, w, co), device="cuda", dtype=bf) for _ in range(2))
                launch(plain_lib, y0)
                launch(halo_lib, y1)
                torch.cuda.synchronize()
                if not torch.equal(y0, y1):
                    raise AssertionError(f"{shape}: the halo instantiation with null rows "
                                         f"differs from the plain one")
                t = {}
                for key, lib, y in (("plain_ms", plain_lib, y0), ("halo_ms", halo_lib, y1),
                                    ("halo_again_ms", halo_lib, y1),
                                    ("plain_again_ms", plain_lib, y0)):
                    t[key] = cs.device_ms(torch, lambda: launch(lib, y), args.reps)
                    sums[key] += t[key] * n_calls
                rows.append({"shape": list(shape), "calls": n_calls, "template": plan.kernel,
                             **t})
                del x, wt, b, y0, y1
            plain = (sums["plain_ms"] + sums["plain_again_ms"]) / 2
            halo = (sums["halo_ms"] + sums["halo_again_ms"]) / 2
            result["paths"][label] = {
                **sums, "plain_mean_ms": plain, "halo_mean_ms": halo,
                "halo_less_plain_ms": halo - plain, "halo_over_plain": halo / plain,
                "noise_ms": abs(sums["plain_ms"] - sums["plain_again_ms"]), "shapes": rows,
                "bit_equal": True}
    # the per-conv cascade's gate with the package's kernel and with the rows
    # ignored (each shard-conv reflects its own rows)
    import numpy as np
    with np.load(os.path.join(HERE, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c2k, s2k = (cs.reflect_tile(torch, d[k], 2048) for k in ("content", "style"))
    eng16 = WCTEngine(mode="16x", dtype=bf)
    pc16 = WCTEngine(mode="16x", dtype=bf, space=cs.SHARDS, devices=["cuda:0"] * cs.SHARDS)
    with torch.inference_mode():
        img, sty = eng16._prep(c2k), eng16._prep(s2k)
        plain = eng16.stylize_device(img, sty)
        good = cs.psnr_device(torch, pc16.stylize_device(img, sty), plain)
        _build._lib = _Swap(plain_lib, never_lib)
        try:
            ignored = cs.psnr_device(torch, pc16.stylize_device(img, sty), plain)
        finally:
            _build._lib = plain_lib
    result["per_conv_gate"] = {"psnr_db": good, "rows_ignored_psnr_db": ignored,
                               "floor_db": cs.BF16_SHARD_MIN_DB}
    ptx_plain, ptx_halo = ring_ptxas(_build.last_build.get("log", "")), ring_ptxas(halo_log)
    result["ptxas"] = {"package_build": ptx_plain, "always_halo_build": ptx_halo}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "bench_bf16_halo_flag.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(card)
    for label, p in result["paths"].items():
        print(f"{label}: plain {p['plain_ms']:.4f}, {p['plain_again_ms']:.4f} ms; halo "
              f"{p['halo_ms']:.4f}, {p['halo_again_ms']:.4f} ms a cascade's conv3x3 (device "
              f"time); halo - plain {p['halo_less_plain_ms']:.4f} ms "
              f"({100 * (p['halo_over_plain'] - 1):.2f} %), noise {p['noise_ms']:.4f} ms")
    g = result["per_conv_gate"]
    print(f"bf16 per-conv 2048^2 vs the bf16 plain cascade: {g['psnr_db']:.2f} dB; with the "
          f"halo rows ignored {g['rows_ignored_psnr_db']:.2f} dB (floor {g['floor_db']})")
    print(json.dumps({**{k: {kk: v for kk, v in p.items() if kk != "shapes"}
                         for k, p in result["paths"].items()}, "per_conv_gate": g}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
