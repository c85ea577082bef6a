"""Collaborative-distillation loss graphs, on tensors.

The port of the reference package's ``train/losses.py``, the three training
wrappers of the original ``model/model.py``:

* :func:`se_distill_losses` — train the small encoder (SE) so that its
  up-dimensioned aux features drive the frozen big decoder (BD): feature KD
  on the relu taps, pixel and perceptual losses.
* :func:`sd_reconstruct_losses` — train the small decoder (SD) to invert
  the frozen SE: pixel and perceptual losses.
* :func:`kd2sd_losses` — adds decoder-feature KD: the SD's aux taps match
  the frozen BD's decoder taps.

Each takes the student's parameters (leaves that require grad), the frozen
ones (tensors that do not) and an NHWC batch, and returns ``(losses,
rec)``: a dict of 0-d float32 tensors and the reconstruction. One
``backward`` of their weighted sum gives the reference's gradients to the
student and none to a frozen tensor. Where the reference wraps a target in
``lax.stop_gradient``, it is computed here under ``torch.no_grad()``: the
kernels run their inference launch and no activation is kept for it.
"""

from __future__ import annotations

import torch

from ..models.specs import StageSpec
from ..models.vgg import apply_decoder, apply_encoder

__all__ = ["mse", "se_distill_losses", "sd_reconstruct_losses", "kd2sd_losses"]


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a.float() - b.float()) ** 2).mean()


def _taps(outs: dict, prefix: str, stage: int) -> list[torch.Tensor]:
    return [outs[f"{prefix}{k}1"] for k in range(1, stage + 1)]


def _perc(rec_be: dict, c_be: dict, stage: int) -> torch.Tensor:
    return sum(mse(a, b) for a, b in zip(_taps(rec_be, "relu", stage),
                                         _taps(c_be, "relu", stage)))


def se_distill_losses(se_params, frozen, batch: torch.Tensor, *, se_spec: StageSpec,
                      be_spec: StageSpec, bd_spec: StageSpec, aux_relu: bool = False,
                      terms: tuple[str, ...] | None = None):
    """SE-stage losses; ``frozen`` is ``{"be": ..., "bd": ...}``.

    feat: sum_k MSE(SE aux_k, BE relu_k); pixl: MSE(BD(SE aux_K), content);
    perc: sum_k MSE(BE(rec) relu_k, BE(content) relu_k). ``terms`` names the
    losses to compute: one left out (weight 0) costs nothing, the BE
    encodes included.
    """
    stage = se_spec.stage
    want = set(terms) if terms is not None else {"feat", "pixl", "perc"}
    be, bd = frozen["be"], frozen["bd"]
    c_se = apply_encoder(se_params, batch, se_spec, aux_relu=aux_relu)
    rec = apply_decoder(bd, c_se[f"aux{stage}1"], bd_spec)["out"]
    losses = {}
    if want & {"feat", "perc"}:
        with torch.no_grad():
            c_be = apply_encoder(be, batch, be_spec)
    if "feat" in want:
        losses["feat"] = sum(mse(a, b) for a, b in zip(
            _taps(c_se, "aux", stage), _taps(c_be, "relu", stage)))
    if "pixl" in want:
        losses["pixl"] = mse(rec, batch)
    if "perc" in want:
        losses["perc"] = _perc(apply_encoder(be, rec, be_spec), c_be, stage)
    return losses, rec


def sd_reconstruct_losses(sd_params, frozen, batch: torch.Tensor, *, sd_spec: StageSpec,
                          se_spec: StageSpec, be_spec: StageSpec,
                          terms: tuple[str, ...] | None = None):
    """SD-stage losses; ``frozen`` is ``{"se": ...}`` plus ``"be"`` where
    ``perc`` is computed. rec = SD(SE(content)); pixel loss and perceptual
    loss through the BE. Without ``perc`` the BE is never evaluated, so this
    mode trains without teacher weights."""
    stage = sd_spec.stage
    want = set(terms) if terms is not None else {"pixl", "perc"}
    with torch.no_grad():
        feat = apply_encoder(frozen["se"], batch, se_spec, aux=False)["out"]
    rec = apply_decoder(sd_params, feat, sd_spec)["out"]
    losses = {}
    if "pixl" in want:
        losses["pixl"] = mse(rec, batch)
    if "perc" in want:
        be = frozen["be"]
        with torch.no_grad():
            c_be = apply_encoder(be, batch, be_spec)
        losses["perc"] = _perc(apply_encoder(be, rec, be_spec), c_be, stage)
    return losses, rec


def kd2sd_losses(sd_params, frozen, batch: torch.Tensor, *, sd_spec: StageSpec,
                 se_spec: StageSpec, be_spec: StageSpec, bd_spec: StageSpec,
                 aux_relu: bool = False):
    """KD2SD losses; ``frozen`` is ``{"be": ..., "bd": ..., "se": ...}``.

    The frozen SE gives both the up-dimensioned aux feature (driving the
    frozen BD, whose decoder taps are the KD targets) and the native one
    (driving the trainable SD, whose aux taps must match them). The SE's aux
    adapters apply a ReLU always, as the reference's ``forward_aux2`` does;
    ``aux_relu`` is the SD's.
    """
    stage = sd_spec.stage
    be, bd, se = frozen["be"], frozen["bd"], frozen["se"]
    with torch.no_grad():
        c_be = apply_encoder(be, batch, be_spec)
        c_se = apply_encoder(se, batch, se_spec, aux_relu=True)
        feats_bd = apply_decoder(bd, c_se[f"aux{stage}1"], bd_spec)
    feats_sd = apply_decoder(sd_params, c_se["out"], sd_spec, aux_relu=aux_relu)
    rec = feats_sd["out"]
    pixl = mse(rec, batch)
    perc = _perc(apply_encoder(be, rec, be_spec), c_be, stage)
    # decoder-feature KD: the SD's aux taps (k = K..2) and the image vs the BD's
    kd = mse(rec, feats_bd["out"])
    for k in range(2, stage + 1):
        kd = kd + mse(feats_sd[f"dec_aux{k}1"], feats_bd[f"dec{k}1"])
    return {"pixl": pixl, "perc": perc, "kd": kd}, rec
