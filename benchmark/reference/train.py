"""The ``wct_se`` distillation step, plain (model/model.py's SE stage,
train/losses.py of the reference): the student encoder SE with its 1x1
adapters on the relu{j}_1 taps; the frozen teacher encoder BE and decoder
BD of the same stage.

    feat = sum_j MSE(SE aux{j}1, BE relu{j}1 of the batch)
    pixl = MSE(BD(SE aux{K}1), batch)
    perc = sum_j MSE(BE relu{j}1 of the reconstruction, BE relu{j}1 of the batch)

then Adam (lr, betas 0.9 / 0.999, eps 1e-8, bias-corrected) on the
weighted sum. Float32, or the control's precision (``precision.py``)."""

from __future__ import annotations

import torch

from benchlib import arch

from .cascade import decode, encode


def _mse(a, b):
    return ((a - b) ** 2).mean()


def losses(student, frozen, batch, student_cfg, teacher_cfg, stage, precision):
    x = batch.permute(0, 3, 1, 2).float()
    _, se = encode(student, x, student_cfg, stage, precision,
                   aux_layers=arch.aux(student_cfg, stage))
    rec = decode(frozen["bd"], se[f"aux{stage}1"], teacher_cfg, stage, precision)
    with torch.no_grad():
        _, be_x = encode(frozen["be"], x, teacher_cfg, stage, precision)
    _, be_rec = encode(frozen["be"], rec, teacher_cfg, stage, precision)
    taps = [f"relu{j}1" for j in range(1, stage + 1)]
    return {"feat": sum(_mse(se[f"aux{t[4]}1"], be_x[t]) for t in taps),
            "pixl": _mse(rec, x),
            "perc": sum(_mse(be_rec[t], be_x[t]) for t in taps)}


class Student:
    """The student's parameters (copied from ``student0``) and Adam's state;
    :meth:`step` is one step on a batch. ``grad1`` holds the first step's
    gradients, each leaf as ``{layer: {"w", "b"}}``."""

    def __init__(self, student0, frozen, *, student_cfg, teacher_cfg, stage, weights, lr,
                 precision="float32", betas=(0.9, 0.999), eps=1e-8):
        self.params = {n: {k: t.detach().clone().requires_grad_(True) for k, t in leaf.items()}
                       for n, leaf in student0.items()}
        self._leaves = [t for leaf in self.params.values() for t in leaf.values()]
        self._m = [torch.zeros_like(t) for t in self._leaves]
        self._v = [torch.zeros_like(t) for t in self._leaves]
        self.frozen, self.weights, self.lr, self.betas, self.eps = frozen, weights, lr, betas, eps
        self.cfgs = (student_cfg, teacher_cfg, stage, precision)
        self.count = 0
        self.grad1 = None

    def step(self, batch) -> dict:
        """One step; returns the losses as 0-d tensors."""
        parts = losses(self.params, self.frozen, batch, *self.cfgs)
        total = sum(self.weights[k] * parts[k] for k in parts)
        grads = torch.autograd.grad(total, self._leaves)
        self.count += 1
        if self.count == 1:
            it = iter(grads)
            self.grad1 = {n: {k: next(it).detach().clone() for k in leaf}
                          for n, leaf in self.params.items()}
        b1, b2 = self.betas
        with torch.no_grad():
            for t, g, m, v in zip(self._leaves, grads, self._m, self._v):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m / (1 - b1 ** self.count)
                v_hat = v / (1 - b2 ** self.count)
                t.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
        return {k: val.detach() for k, val in parts.items()}


def run(student0, frozen, batches, **kw) -> dict:
    """Steps over ``batches`` from ``student0`` (left as it is): each step's
    losses (floats), the first step's gradients and the parameters after the
    last step."""
    s = Student(student0, frozen, **kw)
    out = [{k: float(v) for k, v in s.step(b).items()} for b in batches]
    return {"losses": out, "grad1": s.grad1,
            "params": {n: {k: t.detach() for k, t in leaf.items()}
                       for n, leaf in s.params.items()}}
