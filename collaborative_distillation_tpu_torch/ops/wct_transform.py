"""Whitening & Coloring Transform (WCT) in float32.

The channel covariance comes from the ``sum_gram`` kernel on the card (its
plain version on the CPU); the matrix inverse square root and square root
from ``torch.linalg.eigh`` (a library eigensolver, as ``jnp.linalg.eigh`` is
in the reference) or from a coupled Newton-Schulz iteration of plain
products; whitening and coloring collapse into one C x C coloring matrix
applied as one (P, C) x (C, C) product.
"""

from __future__ import annotations

import torch

from .conv import on_card
from .cuda import stats as _kstats

__all__ = [
    "feature_stats",
    "matrix_isqrt_sqrt_eigh",
    "matrix_isqrt_sqrt_newton",
    "coloring_matrix",
    "wct_transform",
]

# rows whose mean serves as the Gram's shift (see feature_stats)
_SHIFT_ROWS = 4096


def feature_stats(feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Channel mean and covariance of a feature map.

    ``feat``: (..., C); all leading axes are pixels. Returns ``(mean (C,),
    cov (C, C))`` with the reference's ``/(P-1)`` normalization.

    One pass of ``sum_gram`` over the map, shifted by ``s``, the mean of the
    first rows: with ``S = sum(x - s)`` and ``G = (x - s)^T (x - s)``,
    ``mean = s + S/P`` and ``cov = (G - S S^T / P) / (P - 1)``, which is the
    centred covariance exactly in exact arithmetic. Without the shift the
    float32 Gram of a multi-megapixel map cancels against ``P mean mean^T``.

    A map of one pixel has no covariance: it raises ValueError (the
    reference divides 0 by 0 and stylizes to NaN).
    """
    c = feat.shape[-1]
    x = feat.reshape(-1, c).float().contiguous()
    p = x.shape[0]
    if p < 2:
        raise ValueError(f"feature_stats needs at least 2 pixels, got {p} "
                         f"(a 16x16 image reaches relu5_1 at 1x1)")
    shift = x[:_SHIFT_ROWS].mean(0)
    if on_card(x):
        s, g = _kstats.sum_gram(x, shift)
    else:
        s, g = _kstats.sum_gram_plain(x, shift)
    d = s / p
    mean = shift + d
    cov = (g - p * torch.outer(d, d)) / (p - 1)
    return mean, cov


def matrix_isqrt_sqrt_eigh(cov: torch.Tensor, *, eps: float = 1e-8,
                           truncate: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """(cov^-1/2, cov^1/2) via symmetric eigendecomposition.

    Eigenvalues at or below ``truncate * lambda_max`` are dropped rather than
    inverted (the reference's rank cutoff, util_wct.py:25/82-89).
    """
    c = cov.shape[0]
    cov = cov + eps * torch.eye(c, dtype=cov.dtype, device=cov.device)
    lam, v = torch.linalg.eigh(cov)
    lam_max = torch.clamp(lam[-1], min=eps)
    keep = lam > truncate * lam_max
    zero = torch.zeros_like(lam)
    inv_s = torch.where(keep, torch.rsqrt(torch.clamp(lam, min=1e-30)), zero)
    sq_s = torch.where(keep, torch.sqrt(torch.clamp(lam, min=0.0)), zero)
    isqrt = (v * inv_s[None, :]) @ v.T
    sqrt = (v * sq_s[None, :]) @ v.T
    return isqrt, sqrt


def _lambda_max_estimate(a: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Power-iteration lower bound on the largest eigenvalue of SPD ``a``."""
    c = a.shape[0]
    v = torch.full((c,), 1.0 / c ** 0.5, dtype=torch.float32, device=a.device)
    for _ in range(iters):
        w = a @ v
        v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
    # Rayleigh quotient <= lambda_max; floor by trace/c (mean eigenvalue)
    return torch.maximum(v @ (a @ v), torch.trace(a) / c)


def matrix_isqrt_sqrt_newton(cov: torch.Tensor, *, eps: float = 1e-8, iters: int = 24,
                             rel_floor: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(cov^-1/2, cov^1/2) via coupled Newton-Schulz iteration.

    Y_{k+1} = Y_k (3I - Z_k Y_k)/2, Z_{k+1} = (3I - Z_k Y_k)/2 Z_k, with A
    floored by ``max(rel_floor * lambda_max_est, eps)`` and normalized by its
    Frobenius norm; converges quadratically for SPD A.
    """
    c = cov.shape[0]
    eye = torch.eye(c, dtype=torch.float32, device=cov.device)
    a = cov.float()
    delta = torch.clamp(rel_floor * _lambda_max_estimate(a), min=eps)
    a = a + delta * eye
    norm = torch.sqrt(torch.sum(a * a))
    y, z = a / norm, eye
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return z * torch.rsqrt(norm), y * torch.sqrt(norm)


def coloring_matrix(c_cov: torch.Tensor, s_cov: torch.Tensor, *, method: str = "eigh",
                    eps: float = 1e-8, newton_iters: int = 24) -> torch.Tensor:
    """T = Cs^{1/2} @ Cc^{-1/2}: whitening and coloring fused into one C x C map."""
    if method == "eigh":
        c_isqrt, _ = matrix_isqrt_sqrt_eigh(c_cov, eps=eps)
        _, s_sqrt = matrix_isqrt_sqrt_eigh(s_cov, eps=eps)
    elif method == "newton":
        c_isqrt, _ = matrix_isqrt_sqrt_newton(c_cov, eps=eps, iters=newton_iters)
        _, s_sqrt = matrix_isqrt_sqrt_newton(s_cov, eps=eps, iters=newton_iters)
    else:
        raise ValueError(f"unknown WCT method {method!r}")
    return s_sqrt @ c_isqrt


def _wct_single(content_feat, style_mean, style_cov, alpha, *, method, eps,
                newton_iters):
    shape = content_feat.shape
    c = shape[-1]
    x = content_feat.reshape(-1, c).float()
    c_mean, c_cov = feature_stats(x)
    t = coloring_matrix(c_cov, style_cov.float(), method=method, eps=eps,
                        newton_iters=newton_iters)
    # target = T @ (x - c_mean) + s_mean, applied row-wise: (P,C) @ T^T
    target = (x - c_mean) @ t.T + style_mean.float()
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    out = alpha * target + (1.0 - alpha) * x
    return out.reshape(shape)


def wct_transform(content_feat: torch.Tensor, style_mean: torch.Tensor,
                  style_cov: torch.Tensor, alpha=1.0, *, method: str = "eigh",
                  eps: float = 1e-8, newton_iters: int = 24) -> torch.Tensor:
    """Stylize content features with precomputed style statistics
    (util_wct.py ``transform``: whiten, color, add the style mean, blend by
    ``alpha`` with the content feature). ``content_feat`` is (..., C).

    A rank-4 (N, H, W, C) input with N > 1 is a batch of independent images:
    each is whitened with its own statistics. Style stats may be shared
    ((C,), (C, C)) or per image ((N, C), (N, C, C)).
    """
    kw = dict(method=method, eps=eps, newton_iters=newton_iters)
    if content_feat.dim() == 4 and content_feat.shape[0] > 1:
        per_image = style_mean.dim() == 2
        return torch.stack([
            _wct_single(cf, style_mean[i] if per_image else style_mean,
                        style_cov[i] if per_image else style_cov, alpha, **kw)
            for i, cf in enumerate(content_feat)])
    if style_mean.dim() == 2:  # per-image style stats with a single image
        style_mean, style_cov = style_mean[0], style_cov[0]
    return _wct_single(content_feat, style_mean, style_cov, alpha, **kw)
