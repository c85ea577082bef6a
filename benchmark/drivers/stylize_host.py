"""Host to host stylization: ``WCTEngine.stylize(content, style,
as_uint8=True)`` on uint8 arrays in host memory, one client calling at a
fixed rate; a call's latency runs from when it was due to the uint8 result
in host memory (upload, conversion, cascade, readback).

Mix keys: ``content_hw``, ``style_hw``, ``ring`` (distinct host pairs),
``rate_per_s`` (0: back to back), ``host_threads`` (read by ``run.py``),
``alpha``, ``warm_items``, ``trace_items``, ``sample`` (answers compared
with the reference, drawn from the seed among the first 2 x ring calls)."""

from __future__ import annotations

import statistics
import time

from benchlib import checks, counts, device as dv, inputs, loop, weights
from benchlib.trace import Tracer
from drivers.stylize_device import engine
from reference import cascade as ref, precision as lower

# the faults of control.FAULTS a cell of this driver can have: an answer
# altered where it is produced
HELD_TO = ("altered_answer",)



def _u8(torch, x):
    """The program's float -> uint8 rounding (round half up), plainly."""
    return (x.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _float(torch, a, dev):
    """A host uint8 image as float in [0, 1] on ``dev``."""
    return torch.from_numpy(a).to(dev).float() / 255.0


def run(ctx) -> dict:
    torch, dev, mix, cfg = ctx.torch, ctx.device, ctx.mix, ctx.cell.config
    alpha = mix["alpha"]
    pyramid = weights.pyramid(torch, cfg, ctx.seed, ctx.cell.root, dev, tuple(cfg["stages"]))
    ring = inputs.stylize_ring(torch, ctx.cell.bench_dir, mix, ctx.seed, dev, uint8=True)
    ctx.mark("inputs")
    if ctx.system == "program":
        eng = engine(torch, ctx, pyramid)

        def call(c, s):
            return eng.stylize(c, s, alpha, as_uint8=True)
    else:  # the control: the reference a precision below, in the program's place
        def call(c, s):
            img = ref.stylize(pyramid, _float(torch, c, dev), _float(torch, s, dev), cfg,
                              alpha=alpha, precision=lower.control(cfg))
            return _u8(torch, img).cpu().numpy()
    ctx.mark("system")
    n = len(ring)
    for j in range(mix["warm_items"]):
        call(*ring[j % n])
    dv.sync(torch, dev)
    chosen = set(inputs.sample(ctx.seed, 2 * n, mix["sample"]))
    kept = {}

    def keep(i, out):
        if i in chosen:
            kept[i] = out

    tracer = Tracer(torch, dv.is_cuda(dev)) if ctx.trace else None
    dv.reset_peak(torch, dev)
    setup_s = time.perf_counter() - ctx.t_start
    res = loop.paced(lambda i: call(*ring[i % n]), ctx.seconds, mix["rate_per_s"],
                     sync=lambda: dv.sync(torch, dev), tracer=tracer,
                     trace_items=mix["trace_items"], keep=keep, min_items=2 * n)
    peak = dv.peak_bytes(torch, dev)
    trace = tracer.summary() if tracer else None
    del call
    if ctx.system == "program":
        del eng
    dv.free(torch, dev)
    per_sample = []
    for i in sorted(kept):
        c, s = ring[i % n]
        want = _u8(torch, ref.stylize(pyramid, _float(torch, c, dev), _float(torch, s, dev), cfg,
                                      alpha=alpha))
        got = torch.from_numpy(kept.pop(i)).to(dev)
        per_sample.append(checks.image_gaps(torch, got.float() / 255.0, want.float() / 255.0))
        dv.free(torch, dev)
    lat = sorted(res["latency_s"])
    return {
        "attempted": res["items"], "samples": per_sample, "peak_bytes": peak, "trace": trace,
        "e2e": {"setup_s": setup_s,
                "request_p95_ms": 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[-1],
                "peak_gib": peak / 2 ** 30},
        "info": {"request_p50_ms": 1e3 * statistics.median(lat),
                 "late_max_ms": 1e3 * max(res["late_s"]), "requests": len(lat),
                 "window_s": res["window_s"]},
        "work": {"dtype": cfg["dtype"],
                 "flops_per_item": counts.cascade_flops(cfg, mix["content_hw"], mix["style_hw"])},
    }
