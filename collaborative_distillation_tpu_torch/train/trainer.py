"""Distillation trainer: Adam over a trainable student stage, one step a call.

The port of the reference package's ``train/trainer.py``: the same
optimization (Adam, lr 1e-4, the weighted sum of the mode's losses), the
same optional cosine decay of the learning rate, and checkpoints in the
reference's key layout, so a run moves between the two packages either way.
The step runs eagerly on one device: the forward convs, pools and
upsamples launch the hand-written kernels under ``torch.autograd.Function``s
(``ops/cuda/autograd.py``), their backward is PyTorch's.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable

import numpy as np
import torch

from ..models.specs import StageSpec, decoder_spec, encoder_spec
from ..models.vgg import Decoder, Encoder
from ..ops.precision import full_float32
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.params import adam_state_from_jax, adam_state_to_jax
from ..wct.engine import resolve_device
from .losses import kd2sd_losses, sd_reconstruct_losses, se_distill_losses

__all__ = ["TrainConfig", "make_loss_fn", "student_spec", "cosine_lr", "Trainer"]

BF16_ITEM = "ROADMAP.md Queue 1 item 3 (training): bf16 compute with f32 masters"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the reference's ``main.py`` defaults)."""
    mode: str = "wct_se"          # wct_se | wct_sd | wct_sd_kd2sd
    stage: int = 5
    lr: float = 1e-4
    # cosine-decay the lr to lr_final over lr_decay_steps (0 = constant lr,
    # the reference's choice); the schedule's count is checkpointed
    lr_final: float = 0.0
    lr_decay_steps: int = 0
    batch_size: int = 16
    epochs: int = 20
    lw_feat: float = 10.0
    lw_pixl: float = 1.0
    lw_perc: float = 1.0
    lw_kd: float = 1.0
    aux_relu: bool = False        # --updim_relu
    speedup: int = 16
    compute_dtype: str = "float32"


def make_loss_fn(cfg: TrainConfig) -> tuple[Callable, dict[str, float]]:
    """(loss_graph(params, frozen, batch) -> (loss_dict, rec), loss_weights)."""
    k = cfg.stage
    be_spec = encoder_spec("original", k)
    bd_spec = decoder_spec("original", k)
    se_spec = encoder_spec("16x", k, aux=True)
    if cfg.mode == "wct_se":
        weights = {"feat": cfg.lw_feat, "pixl": cfg.lw_pixl, "perc": cfg.lw_perc}
        fn = partial(se_distill_losses, se_spec=se_spec, be_spec=be_spec,
                     bd_spec=bd_spec, aux_relu=cfg.aux_relu,
                     terms=tuple(n for n, w in weights.items() if w))
    elif cfg.mode == "wct_sd":
        weights = {"pixl": cfg.lw_pixl, "perc": cfg.lw_perc}
        fn = partial(sd_reconstruct_losses, sd_spec=decoder_spec("16x", k), se_spec=se_spec,
                     be_spec=be_spec, terms=tuple(n for n, w in weights.items() if w))
    elif cfg.mode == "wct_sd_kd2sd":
        weights = {"pixl": cfg.lw_pixl, "perc": cfg.lw_perc, "kd": cfg.lw_kd}
        fn = partial(kd2sd_losses, sd_spec=decoder_spec("16x", k, aux=True), se_spec=se_spec,
                     be_spec=be_spec, bd_spec=bd_spec, aux_relu=cfg.aux_relu)
    else:
        raise ValueError(f"unknown training mode {cfg.mode!r}")
    return fn, weights


def student_spec(cfg: TrainConfig) -> StageSpec:
    """The spec of the stage a mode trains."""
    if cfg.mode == "wct_se":
        return encoder_spec("16x", cfg.stage, aux=True)
    if cfg.mode == "wct_sd":
        return decoder_spec("16x", cfg.stage)
    if cfg.mode == "wct_sd_kd2sd":
        return decoder_spec("16x", cfg.stage, aux=True)
    raise ValueError(f"unknown training mode {cfg.mode!r}")


def cosine_lr(lr: float, lr_final: float, decay_steps: int, count: int) -> float:
    """optax's ``cosine_decay_schedule(lr, decay_steps, alpha=lr_final / lr)``
    at step ``count``: it holds ``lr_final`` past ``decay_steps``."""
    alpha = lr_final / lr
    t = min(count, decay_steps)
    return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps)) + alpha)


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, torch.float32)
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _tensors(tree, device) -> dict:
    """A parameter dict of tensors or arrays -> float32 tensors on ``device``."""
    return {name: {kind: _tensor(a, device) for kind, a in leaf.items()}
            for name, leaf in tree.items()}


class Trainer:
    """Holds the student as a trainable stage and its Adam state; runs one
    step a call on ``device`` (``"cuda"`` unless the caller asks for the CPU).

    ``student`` and ``frozen`` are parameter dicts (``{layer: {"w", "b"}}``,
    tensors or arrays); ``frozen`` maps ``"be"``, ``"bd"``, ``"se"`` to them
    as the mode needs. ``params`` is the student's dict of leaves.
    """

    def __init__(self, cfg: TrainConfig, student, frozen, *, device="cuda"):
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r}: the port trains in float32; see "
                f"{BF16_ITEM}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.loss_graph, self.loss_weights = make_loss_fn(cfg)
        spec = student_spec(cfg)
        cls = Encoder if spec.kind == "encoder" else Decoder
        self.student = cls(spec, _tensors(student, self.device), trainable=True)
        self.params = self.student.params()
        self.frozen = {k: _tensors(v, self.device) for k, v in frozen.items()
                       if v is not None}
        self.opt = torch.optim.Adam([t for leaf in self.params.values() for t in leaf.values()],
                                    lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        self.sched_count = 0     # the schedule's own count, as optax keeps it

    def lr_at(self, count: int) -> float:
        cfg = self.cfg
        if not cfg.lr_decay_steps:
            return cfg.lr
        return cosine_lr(cfg.lr, cfg.lr_final, cfg.lr_decay_steps, count)

    def train_step(self, batch) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """One optimization step on an (N, H, W, 3) batch (float in [0, 1],
        or uint8, normalized on the device); returns (losses, rec), detached."""
        x = (batch if isinstance(batch, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(batch))).to(self.device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        with full_float32():
            losses, rec = self.loss_graph(self.params, self.frozen, x)
            total = sum(self.loss_weights[name] * val for name, val in losses.items())
            self.opt.zero_grad(set_to_none=True)
            total.backward()
            for group in self.opt.param_groups:
                group["lr"] = self.lr_at(self.sched_count)
            self.opt.step()
        if self.cfg.lr_decay_steps:
            self.sched_count += 1
        return {k: v.detach() for k, v in losses.items()}, rec.detach()

    # --- checkpoints, in the reference's layout ---

    def _opt_tree(self):
        count, mu, nu = adam_state_to_jax(self.opt.state_dict(), self.params)
        sched = (np.int32(self.sched_count),) if self.cfg.lr_decay_steps else ()
        return ((count, mu, nu), sched)

    def _meta(self, epoch: int, step: int) -> dict:
        return {"epoch": epoch, "step": step, "mode": self.cfg.mode, "stage": self.cfg.stage}

    def save(self, path: str, *, epoch: int = 0, step: int = 0) -> None:
        save_checkpoint(path, {"params": self.params, "opt_state": self._opt_tree(),
                               "meta": self._meta(epoch, step)})

    def restore(self, path: str) -> dict:
        """Load a checkpoint of either package into this trainer; returns its
        meta (``epoch``, ``step``, ``mode``, ``stage``)."""
        tree = load_checkpoint(path, {"params": self.params, "opt_state": self._opt_tree(),
                                      "meta": self._meta(0, 0)})
        with torch.no_grad():
            for name, leaf in self.params.items():
                for kind, t in leaf.items():
                    t.copy_(torch.from_numpy(np.asarray(tree["params"][name][kind])))
        (count, mu, nu), sched = tree["opt_state"]
        self.opt.load_state_dict(adam_state_from_jax(
            count, mu, nu, self.params, self.opt.state_dict()["param_groups"]))
        if sched:
            self.sched_count = int(sched[0])
        return tree["meta"]
