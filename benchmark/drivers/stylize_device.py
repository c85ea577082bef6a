"""Device-resident stylization: ``WCTEngine.stylize_device`` on float pairs
already on the card, back to back, at most one image dispatched ahead.

Mix keys: ``content_hw``, ``style_hw``, ``ring`` (distinct pairs, item i
takes pair i mod ring), ``slab_rows`` (0: the plain per-stage path),
``alpha``, ``warm_items``, ``trace_items``, ``sample`` (outputs compared
with the reference, drawn from the seed among the first 2 x ring items)."""

from __future__ import annotations

import os
import time

from benchlib import checks, counts, device as dv, inputs, loop, weights
from benchlib.trace import Tracer
from reference import cascade as ref, precision as lower

# the faults of control.FAULTS a cell of this driver can have: an answer
# altered where it is produced
HELD_TO = ("altered_answer",)



def engine(torch, ctx, pyramid):
    """The program: a ``WCTEngine`` over the configuration's weights."""
    from collaborative_distillation_tpu_torch.models.zoo import stage_specs
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    cfg, mix = ctx.cell.config, ctx.mix
    kw = dict(stages=tuple(cfg["stages"]), slab_rows=mix.get("slab_rows", 0),
              device=ctx.device, dtype=getattr(torch, cfg["dtype"]))
    if cfg["weights"]["kind"] == "files":
        return WCTEngine(mode=cfg["family"],
                         weights_root=os.path.join(ctx.cell.root, cfg["weights"]["root"]), **kw)
    specs = {k: stage_specs(cfg["family"], k) for k in cfg["stages"]}
    return WCTEngine(mode=cfg["family"], pyramid={
        k: {"enc_spec": specs[k][0], "dec_spec": specs[k][1], **pyramid[k]}
        for k in cfg["stages"]}, **kw)


def run(ctx) -> dict:
    torch, dev, mix, cfg = ctx.torch, ctx.device, ctx.mix, ctx.cell.config
    alpha = mix["alpha"]
    pyramid = weights.pyramid(torch, cfg, ctx.seed, ctx.cell.root, dev, tuple(cfg["stages"]))
    ring = inputs.stylize_ring(torch, ctx.cell.bench_dir, mix, ctx.seed, dev)
    ctx.mark("inputs")
    if ctx.system == "program":
        eng = engine(torch, ctx, pyramid)

        def call(c, s):
            return eng.stylize_device(c, s, alpha)
    else:  # the control: the reference a precision below, in the program's place
        def call(c, s):
            return ref.stylize(pyramid, c, s, cfg, alpha=alpha, precision=lower.control(cfg))
    ctx.mark("system")
    n = len(ring)
    for j in range(mix["warm_items"]):
        out = call(*ring[j % n])
    # the sampled outputs are copied into buffers made now, so that every
    # seed's peak holds the same bytes whichever items it samples
    chosen = inputs.sample(ctx.seed, 2 * n, mix["sample"])
    slots = dict(zip(chosen, (torch.empty_like(out) for _ in chosen)))
    del out
    dv.sync(torch, dev)
    kept = {}

    def keep(i, out):
        if i in slots:
            kept[i] = slots[i].copy_(out)

    tracer = Tracer(torch, dv.is_cuda(dev)) if ctx.trace else None
    dv.reset_peak(torch, dev)
    setup_s = time.perf_counter() - ctx.t_start
    res = loop.closed_loop(torch, lambda i: call(*ring[i % n]), ctx.seconds,
                           cuda=dv.is_cuda(dev), tracer=tracer,
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
        per_sample.append(checks.image_gaps(torch, kept.pop(i),
                                            ref.stylize(pyramid, c, s, cfg, alpha=alpha)))
        dv.free(torch, dev)
    h, w = mix["content_hw"]
    return {
        "attempted": res["items"], "samples": per_sample, "peak_bytes": peak, "trace": trace,
        "e2e": {"setup_s": setup_s,
                "mpix_per_s": res["items"] * h * w / 1e6 / res["window_s"],
                "peak_gib": peak / 2 ** 30},
        "work": {"dtype": cfg["dtype"],
                 "flops_per_item": counts.cascade_flops(cfg, mix["content_hw"], mix["style_hw"]),
                 "conv3x3": lambda peak_flops, peak_bytes: counts.conv3x3_least_s(
                     cfg, mix["content_hw"], mix["style_hw"], peak_flops, peak_bytes)},
    }
