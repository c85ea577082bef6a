"""The encoders' ``conv0`` folded into ``conv1_1``: what the reference's
``packed`` computes on its slab paths, without its width layout.

The reference's ``models/packed_vgg.py`` does two things under ``packed``:
it lays the width out in phase columns folded into the channels (a TPU lane
layout the port's NHWC kernels have no use for, so it is not ported), and
``pack_stage_params`` folds every encoder's ``conv0`` (the 1x1 step
RGB -> BGR x255 - mean) into ``conv1_1``. Only the fold is ported. A
pointwise affine commutes with reflect padding, so ``conv1_1(pad(conv0(x)))``
is one 3x3 conv with ``W'[ky, kx] = A @ W[ky, kx]`` and ``b' = b +
sum_taps W[ky, kx]^T b0``, exact at the borders too. The folded ``conv1_1``
is still a reflect conv from 3 channels, run by the same kernels; the fold
removes one full-resolution product per encoder run.
"""

from __future__ import annotations

import numpy as np
import torch

from .specs import StageSpec
from .vgg import Params, apply_encoder

__all__ = ["FoldedParams", "pack_stage_params", "apply_encoder_packed"]


class FoldedParams(dict):
    """An encoder's parameter tree whose ``conv0`` is folded into its first
    3x3 conv (:func:`pack_stage_params`). The encoders skip ``conv0`` on such
    a tree, and refuse any other tree that lacks one."""

    conv0_folded = True


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def pack_stage_params(params: Params, spec: StageSpec) -> Params:
    """A stage's tree with the encoder's ``conv0`` folded into ``conv1_1``: a
    :class:`FoldedParams` with no ``conv0`` entry and every other layer as it
    was. A decoder's tree, an encoder's without ``conv0`` in its spec and a
    tree already folded come back as they are.

    The reference's order exactly: the weights in their own dtype (the
    engine's, bf16 included) are widened to float32, composed there by
    numpy, and rounded once back to that dtype, on their own device."""
    if spec.kind != "encoder" or not spec.has_conv0 or getattr(params, "conv0_folded", False):
        return params
    first = spec.layers[0].name
    a = _np32(params["conv0"]["w"])[0, 0]      # (3 in, 3 out)
    b0 = _np32(params["conv0"]["b"])
    w, b = params[first]["w"], params[first]["b"]
    w32 = _np32(w)
    # y = sum_t W_t (A x_t + b0) + b = sum_t (A @ W_t) x_t + (b + sum_t W_t^T b0)
    wf = np.einsum("ji,hwio->hwjo", a, w32)
    bf = _np32(b) + np.einsum("hwio,i->o", w32, b0)
    folded = FoldedParams((name, leaf) for name, leaf in params.items() if name != "conv0")
    folded[first] = {"w": torch.from_numpy(wf).to(w.device, w.dtype),
                     "b": torch.from_numpy(bf).to(b.device, b.dtype)}
    return folded


def apply_encoder_packed(params: Params, x: torch.Tensor, spec: StageSpec,
                         **kw) -> dict[str, torch.Tensor]:
    """:func:`..models.vgg.apply_encoder` over a folded tree (no ``conv0``
    step; ``kw`` as there); any other tree raises."""
    if not getattr(params, "conv0_folded", False):
        raise TypeError("apply_encoder_packed needs a tree folded by pack_stage_params")
    return apply_encoder(params, x, spec, **kw)
