"""Style-statistic helpers: Gram matrices and AdaIN.

The feature statistics bundled with the reference's student models
(model/model_cd.py:14-47: ``gram_matrix``, ``gram_matrix_ave``,
``calc_mean_std``, ``adaptive_instance_normalization``), for style-loss
experiments and AdaIN-style transfer. Plain PyTorch in float32 on either
device; the Gram product runs with TF32 off, as the reference's
``Precision.HIGHEST``.
"""

from __future__ import annotations

import torch

from .precision import full_float32

__all__ = ["gram_matrix", "gram_matrix_ave", "calc_mean_std", "adain"]


def gram_matrix(feat: torch.Tensor, *, normalize_hw_only: bool = False) -> torch.Tensor:
    """Per-sample Gram matrix of an NHWC feature map -> (N, C, C), divided
    by C*H*W (model_cd.py:14-19), or by H*W with ``normalize_hw_only``
    (``gram_matrix_ave``, 43-47)."""
    n, h, w, c = feat.shape
    x = feat.reshape(n, h * w, c).float()
    with full_float32():
        g = torch.bmm(x.transpose(1, 2), x)
    return g / (h * w if normalize_hw_only else c * h * w)


def gram_matrix_ave(feat: torch.Tensor) -> torch.Tensor:
    return gram_matrix(feat, normalize_hw_only=True)


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample, per-channel spatial mean and std (population variance
    plus ``eps``) -> ((N, 1, 1, C), (N, 1, 1, C))."""
    mean = feat.mean(dim=(1, 2), keepdim=True)
    var = feat.var(dim=(1, 2), keepdim=True, correction=0)
    return mean, torch.sqrt(var + eps)


def adain(content_feat: torch.Tensor, style_feat: torch.Tensor) -> torch.Tensor:
    """Adaptive instance normalization: the content features re-scaled to
    the style features' channel statistics (model_cd.py:31-40)."""
    c_mean, c_std = calc_mean_std(content_feat)
    s_mean, s_std = calc_mean_std(style_feat)
    return (content_feat - c_mean) / c_std * s_std + s_mean
