"""Distillation training: ``Trainer.train_step`` on batches already on the
card, back to back, at most one step dispatched ahead.

Set-up builds one trainer from the seed (the student, with its adapters,
drawn from the seed; the frozen teacher of ``mix["teacher"]`` drawn from
the seed) and drives it through its first ``ref_steps`` steps on the first
batches of the ring, which warm every shape; the window goes on with the
same trainer. The reference follows those first steps from the same
initial student and teacher, on the same batches.

Mix keys: ``mode`` (``wct_se``), ``stage``, ``batch``, ``crop``,
``shorter_side``, ``ring`` (distinct batches), ``teacher`` (a configuration
name), ``lr``, ``loss_weights``, ``ref_steps``, ``trace_items``."""

from __future__ import annotations

import time

from benchlib import checks, counts, device as dv, inputs, loop, weights
from benchlib.trace import Tracer
from reference import precision as lower, train as ref

# the faults of control.FAULTS a cell of this driver can have: a step that
# leaves its state unchanged, a step over half its batch
HELD_TO = ("unchanged_state", "half_batch")



class _Program:
    """The program's trainer, read the way the reference is read: its
    masters, and the first step's gradients from Adam's state after it."""

    def __init__(self, ctx, student0, frozen):
        from collaborative_distillation_tpu_torch.train.trainer import TrainConfig, Trainer
        mix = ctx.mix
        w = mix["loss_weights"]
        cfg = TrainConfig(mode=mix["mode"], stage=mix["stage"], batch_size=mix["batch"],
                          lr=mix["lr"], lw_feat=w["feat"], lw_pixl=w["pixl"], lw_perc=w["perc"],
                          compute_dtype=ctx.cell.config["dtype"])
        self.trainer = Trainer(cfg, student0, frozen, device=ctx.device)
        self.params = self.trainer.params
        self.grad1 = None

    def step(self, batch):
        losses, _ = self.trainer.train_step(batch)
        if self.grad1 is None:   # a leaf Adam never saw has no state: its gradient reads 0
            beta1 = self.trainer.opt.param_groups[0]["betas"][0]
            state = self.trainer.opt.state
            self.grad1 = {n: {k: (state[t]["exp_avg"] / (1 - beta1)
                                  if "exp_avg" in state.get(t, {}) else t.detach() * 0)
                              for k, t in leaf.items()} for n, leaf in self.params.items()}
        return losses


def run(ctx) -> dict:
    torch, dev, mix, cfg = ctx.torch, ctx.device, ctx.mix, ctx.cell.config
    teacher_cfg = ctx.cell.other_config(mix["teacher"])
    stage = mix["stage"]
    teacher = weights.seeded_pyramid(torch, teacher_cfg, ctx.seed, dev, (stage,))[stage]
    frozen = {"be": teacher["enc"], "bd": teacher["dec"]}
    student0 = weights.seeded_student(torch, cfg, stage, ctx.seed, dev)
    batches = inputs.train_ring(torch, ctx.cell.bench_dir, mix, ctx.seed, dev)
    ctx.mark("inputs")
    kw = dict(student_cfg=cfg, teacher_cfg=teacher_cfg, stage=stage,
              weights=mix["loss_weights"], lr=mix["lr"])
    if ctx.system == "program":
        system = _Program(ctx, weights.clone(student0), frozen)
    else:  # the control: the reference a precision below, in the program's place
        system = ref.Student(student0, frozen, precision=lower.control(cfg), **kw)
    ctx.mark("system")
    n_ref = mix["ref_steps"]
    got = {"losses": []}
    for i in range(n_ref):
        got["losses"].append({k: float(v) for k, v in system.step(batches[i]).items()})
        ctx.mark(f"step{i + 1}")
    got["grad1"] = weights.clone(system.grad1)
    got["delta"] = {n: {k: (t.detach() - student0[n][k]).clone() for k, t in leaf.items()}
                    for n, leaf in system.params.items()}
    dv.sync(torch, dev)
    n = len(batches)
    tracer = Tracer(torch, dv.is_cuda(dev)) if ctx.trace else None
    dv.reset_peak(torch, dev)
    setup_s = time.perf_counter() - ctx.t_start
    res = loop.closed_loop(torch, lambda i: system.step(batches[(n_ref + i) % n]), ctx.seconds,
                           cuda=dv.is_cuda(dev), tracer=tracer, trace_items=mix["trace_items"])
    peak = dv.peak_bytes(torch, dev)
    trace = tracer.summary() if tracer else None
    del system
    dv.free(torch, dev)
    want = ref.run(student0, frozen, batches[:n_ref], **kw)
    want["delta"] = {nm: {k: t - student0[nm][k] for k, t in leaf.items()}
                     for nm, leaf in want["params"].items()}
    return {
        "attempted": res["items"], "samples": [checks.train_gaps(got, want)],
        "peak_bytes": peak, "trace": trace,
        "e2e": {"setup_s": setup_s,
                "train_images_per_s": res["items"] * mix["batch"] / res["window_s"],
                "peak_gib": peak / 2 ** 30},
        "work": {"dtype": cfg["dtype"],
                 "flops_per_item": counts.wct_se_flops(cfg, teacher_cfg, stage, mix["batch"],
                                                       mix["crop"])},
    }
