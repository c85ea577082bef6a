"""Collaborative-distillation training: the loss graphs, the trainer and the
L1-pruning initializer of the students."""

from .losses import kd2sd_losses, mse, sd_reconstruct_losses, se_distill_losses
from .prune import l1_keep_indices, prune_to_student
from .trainer import TrainConfig, Trainer, make_loss_fn

__all__ = ["mse", "se_distill_losses", "sd_reconstruct_losses", "kd2sd_losses",
           "l1_keep_indices", "prune_to_student", "TrainConfig", "Trainer", "make_loss_fn"]
