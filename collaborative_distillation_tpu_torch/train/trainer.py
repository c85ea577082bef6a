"""Distillation trainer: Adam over a trainable student stage, one step a call.

The port of the reference package's ``train/trainer.py``: the same
optimization (Adam, lr 1e-4, the weighted sum of the mode's losses), the
same optional cosine decay of the learning rate, and checkpoints in the
reference's key layout, so a run moves between the two packages either way.
The step runs eagerly on one device: the forward convs, pools and
upsamples launch the hand-written kernels under ``torch.autograd.Function``s
(``ops/cuda/autograd.py``), their backward is PyTorch's.

``compute_dtype="bfloat16"`` is the reference's mixed precision: the step
runs in bf16 (the bf16 kernels on the card) on bf16 copies of the float32
masters, cast inside the differentiated graph, so the gradients reach the
masters in float32 and Adam's state stays float32; the losses are float32
sums and the reconstruction comes back in float32. Checkpoints hold the
float32 masters either way.

Data parallelism (``mesh=`` with a ``data`` axis of D slots) is the
reference's sharded step in PyTorch's idiom: one replica of the student a
slot, each with its own tensors even where a device repeats (``["cuda:0"]
* 4`` runs the code of four cards on one). The batch goes to the replicas
in order, one equal shard each; each replica runs its forward and then its
backward before the next one starts (the launches queue on its card, so
the cards overlap while the host moves on); the root replica's gradient
becomes the mean over the D replicas, and over the processes of the
mesh's ``torch.distributed`` group (one all-reduce a step; each process is
handed its own rows of the global batch); Adam steps the root's masters, which
are then copied into every other replica. Shards are equal, so the mean is
the gradient of the global batch's mean loss, the one the reference's
step differentiates.
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
from ..ops.precision import bf16_full_reduction, full_float32
from ..parallel.mesh import Mesh
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.params import adam_state_from_jax, adam_state_to_jax
from ..wct.engine import resolve_device
from .losses import kd2sd_losses, sd_reconstruct_losses, se_distill_losses

__all__ = ["TrainConfig", "make_loss_fn", "student_spec", "cosine_lr", "Trainer"]

# the compute dtypes the port trains in; float16 has no kernels in the port
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FP16_ITEM = "ROADMAP.md, 'Not ported': compute_dtype='float16'"


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
    compute_dtype: str = "float32"   # or "bfloat16": bf16 compute, float32 masters


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


def _tensors(tree, device, dtype=torch.float32) -> dict:
    """A parameter dict of tensors or arrays -> float32 tensors on ``device``,
    then cast to ``dtype``."""
    return {name: {kind: _tensor(a, device).to(dtype) for kind, a in leaf.items()}
            for name, leaf in tree.items()}


def _cast(params, dtype) -> dict:
    """The masters as ``dtype``, differentiably: their gradients come back
    through the cast in float32 (in float32 the masters themselves)."""
    return {name: {kind: t.to(dtype) for kind, t in leaf.items()}
            for name, leaf in params.items()}


def _leaves(params) -> list[torch.Tensor]:
    return [t for leaf in params.values() for t in leaf.values()]


def _to_batch(batch, device) -> torch.Tensor:
    """A batch on ``device`` in float32: uint8 is normalized there."""
    x = (batch if isinstance(batch, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(batch))).to(device)
    return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()


class Trainer:
    """Holds the student as a trainable stage and its Adam state; runs one
    step a call on ``device`` (``"cuda"`` unless the caller asks for the CPU),
    or with ``mesh`` on one replica a ``data`` slot of the mesh (its
    ``space`` axis must be 1; ``device`` is then unused).

    ``student`` and ``frozen`` are parameter dicts (``{layer: {"w", "b"}}``,
    tensors or arrays); ``frozen`` maps ``"be"``, ``"bd"``, ``"se"`` to them
    as the mode needs. ``params`` is the student's dict of float32 leaves
    (the masters; with a mesh the root replica's, on the first slot's
    device); in bf16 the frozen teachers are cast once, here: they are
    constants, so this is the reference's cast at every step. They are
    placed once on each distinct device (``frozen`` is the root device's).
    """

    def __init__(self, cfg: TrainConfig, student, frozen, *, device="cuda",
                 mesh: Mesh | None = None):
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype={cfg.compute_dtype!r}: the port trains in "
                f"{' or '.join(COMPUTE_DTYPES)}; see {FP16_ITEM}")
        if mesh is not None and mesh.shape["space"] != 1:
            raise ValueError(f"the trainer shards the batch over the mesh's 'data' axis; "
                             f"its 'space' axis must be 1, got {mesh.shape['space']}")
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        self.mesh = mesh
        self.devices = ([resolve_device(device)] if mesh is None
                        else [resolve_device(row[0]) for row in mesh.devices])
        self.device = self.devices[0]
        self.cfg = cfg
        self.loss_graph, self.loss_weights = make_loss_fn(cfg)
        spec = student_spec(cfg)
        cls = Encoder if spec.kind == "encoder" else Decoder
        self.replicas = [cls(spec, _tensors(student, d), trainable=True) for d in self.devices]
        self.student = self.replicas[0]
        self.params = self.student.params()
        on = {}
        for d in self.devices:
            if d not in on:
                on[d] = {k: _tensors(v, d, self.dtype) for k, v in frozen.items()
                         if v is not None}
        self._frozen_on = on
        self.frozen = on[self.device]
        # float32: no TF32 anywhere; bf16: every bf16 product, forward and
        # backward, reduces in float32 (cuBLAS's conv0 and aux adapters)
        self._precision = full_float32 if self.dtype == torch.float32 else bf16_full_reduction
        self.opt = torch.optim.Adam(_leaves(self.params), lr=cfg.lr, betas=(0.9, 0.999),
                                    eps=1e-8)
        self.sched_count = 0     # the schedule's own count, as optax keeps it

    def lr_at(self, count: int) -> float:
        cfg = self.cfg
        if not cfg.lr_decay_steps:
            return cfg.lr
        return cosine_lr(cfg.lr, cfg.lr_final, cfg.lr_decay_steps, count)

    def train_step(self, batch) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """One optimization step on an (N, H, W, 3) batch (float in [0, 1],
        or uint8, normalized on the device in float32); returns (losses,
        rec), detached, both float32, on the root device. With a mesh N
        must divide into its D shards; in a group of W processes (the
        mesh's ``processes``) the batch is this process's N rows of a
        global batch of W x N, the rows of process ``rank`` from
        ``rank x N``. The losses are the global batch's and ``rec`` is the
        whole global batch's, in batch order."""
        if self.mesh is None:
            x = _to_batch(batch, self.device)
            with self._precision():
                losses, rec = self.loss_graph(_cast(self.params, self.dtype), self.frozen,
                                              x.to(self.dtype))
                total = sum(self.loss_weights[name] * val for name, val in losses.items())
                self.opt.zero_grad(set_to_none=True)
                total.backward()
                self._adam_step()
            return {k: v.detach() for k, v in losses.items()}, rec.detach().float()
        return self._data_parallel_step(batch)

    def _adam_step(self) -> None:
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(self.sched_count)
        self.opt.step()
        if self.cfg.lr_decay_steps:
            self.sched_count += 1

    def _data_parallel_step(self, batch):
        world = self.mesh.processes
        n, d = len(batch), len(self.replicas)
        if n % d:
            raise ValueError(f"batch_size {n * world} not divisible by {d * world} devices")
        per = n // d
        # every shard uploaded first: a copy from pageable host memory waits
        # for the work queued on its card, which would hold each replica's
        # upload behind the replica before it
        xs = [_to_batch(batch[i * per:(i + 1) * per], dev) for i, dev in enumerate(self.devices)]
        shard_losses, recs = [], []
        with self._precision():
            # each replica's forward, then its backward, in turn: a backward
            # returns once its launches are queued, so the cards overlap, and
            # one replica's activations are alive at a time; one backward
            # over all replicas runs their Python backward nodes on a thread
            # a card, which wait on each other for the GIL
            for replica, dev, x in zip(self.replicas, self.devices, xs):
                replica.zero_grad(set_to_none=True)
                losses, rec = self.loss_graph(_cast(replica.params(), self.dtype),
                                              self._frozen_on[dev], x.to(self.dtype))
                sum(self.loss_weights[k] * v for k, v in losses.items()).backward()
                shard_losses.append(losses)
                recs.append(rec.detach().float())
            names = sorted(shard_losses[0])
            mean = self._mean_over_replicas(names, shard_losses)
            self._adam_step()
        self._copy_masters()
        losses = dict(zip(names, mean[-len(names):].clone().unbind()))
        rec = torch.cat([r.to(self.device) for r in recs])
        if world > 1:
            parts = [torch.empty_like(rec) for _ in range(world)]
            torch.distributed.all_gather(parts, rec)
            rec = torch.cat(parts)
        return losses, rec

    def _mean_over_replicas(self, names, shard_losses) -> torch.Tensor:
        """Sets the root's ``.grad`` to the mean of every replica's gradient
        over the replicas and processes; returns the bucket it reduced:
        the flat gradients, then the losses ``names``, each a mean."""
        world = self.mesh.processes
        bucket = None
        for replica, losses in zip(self.replicas, shard_losses):
            flat = torch.cat([(torch.zeros_like(t) if t.grad is None else t.grad).reshape(-1)
                              for t in _leaves(replica.params())]
                             + [losses[k].detach().float().reshape(1) for k in names])
            bucket = flat.to(self.device) if bucket is None else bucket + flat.to(self.device)
        bucket /= len(self.replicas)
        if world > 1:
            torch.distributed.all_reduce(bucket)
            bucket /= world
        at = 0
        for t in _leaves(self.params):
            t.grad = bucket[at:at + t.numel()].view_as(t)
            at += t.numel()
        return bucket

    def _copy_masters(self) -> None:
        """Every other replica's masters := the root's, bit for bit."""
        with torch.no_grad():
            root = _leaves(self.params)
            for replica in self.replicas[1:]:
                for t, src in zip(_leaves(replica.params()), root):
                    t.copy_(src)

    # --- checkpoints, in the reference's layout ---

    def _opt_tree(self):
        count, mu, nu = adam_state_to_jax(self.opt.state_dict(), self.params)
        sched = (np.int32(self.sched_count),) if self.cfg.lr_decay_steps else ()
        return ((count, mu, nu), sched)

    def _meta(self, epoch: int, step: int) -> dict:
        return {"epoch": epoch, "step": step, "mode": self.cfg.mode, "stage": self.cfg.stage}

    def state(self, *, epoch: int = 0, step: int = 0) -> dict:
        """The checkpoint's tree: ``params``, ``opt_state`` (Adam's count, mu
        and nu, and the schedule's count) and ``meta``, what :meth:`save`
        writes; ``utils.checkpoint.save_checkpoint_dcp`` takes it too."""
        return {"params": self.params, "opt_state": self._opt_tree(),
                "meta": self._meta(epoch, step)}

    def save(self, path: str, *, epoch: int = 0, step: int = 0) -> None:
        save_checkpoint(path, self.state(epoch=epoch, step=step))

    def restore(self, path: str) -> dict:
        """Load a checkpoint of either package into this trainer (every
        replica); returns its meta (``epoch``, ``step``, ``mode``,
        ``stage``)."""
        return self.load_state(load_checkpoint(path, self.state()))

    def load_state(self, tree) -> dict:
        """Load a tree shaped as :meth:`state`'s (numpy leaves, as the
        checkpoint loaders return it) into this trainer; returns its meta."""
        with torch.no_grad():
            for name, leaf in self.params.items():
                for kind, t in leaf.items():
                    t.copy_(torch.from_numpy(np.asarray(tree["params"][name][kind])))
        self._copy_masters()
        (count, mu, nu), sched = tree["opt_state"]
        self.opt.load_state_dict(adam_state_from_jax(
            count, mu, nu, self.params, self.opt.state_dict()["param_groups"]))
        if sched:
            self.sched_count = int(sched[0])
        return tree["meta"]
