"""Whitening & Coloring Transform (WCT) in float32.

A bfloat16 feature map keeps its statistics, ``eigh`` and T in float32 and
gets its result back in bf16, as the reference's bf16 engine does.

The channel covariance comes from the ``sum_gram`` kernel on the card (its
plain version on the CPU); the matrix inverse square root and square root
from a symmetric eigendecomposition or from a coupled Newton-Schulz
iteration of plain products; whitening and coloring collapse into one C x C
coloring matrix applied as one (P, C) x (C, C) product. The slab cascade
folds the whole transform into one affine map applied by the
``conv1x1_bias`` kernel (:func:`wct_apply_folded`).

The eigendecomposition: on the card, covariances up to ``sym_eigh``'s 128
channels go to that kernel, the content's and the style's in one launch,
and the host waits for nothing; wider ones, and every one on the CPU, to
``torch.linalg.eigh`` (a library eigensolver, as ``jnp.linalg.eigh`` is in
the reference), one matrix a call. ``EIGH`` counts the matrices each took.
A blend weight ``alpha`` given as a number stays on the host, a float32
scalar operand of the card's kernels, never a copy to the card.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .conv import on_card
from .cuda import conv1x1 as _k1x1
from .cuda import eigh as _keigh
from .cuda import stats as _kstats

__all__ = [
    "feature_stats",
    "gram_shift",
    "shifted_sum_gram",
    "stats_from_sums",
    "matrix_isqrt_sqrt_eigh",
    "matrix_isqrt_sqrt_newton",
    "coloring_matrix",
    "wct_transform",
    "wct_apply_folded",
    "alpha_on",
    "EIGH",
]

# rows whose mean serves as the Gram's shift (see feature_stats)
_SHIFT_ROWS = 4096

# matrices decomposed by each path (utils.profiling.counters reads them)
EIGH = {"kernel": 0, "library": 0}


def feature_stats(feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Channel mean and covariance of a feature map.

    ``feat``: (..., C); all leading axes are pixels. Returns ``(mean (C,),
    cov (C, C))`` with the reference's ``/(P-1)`` normalization.

    One pass of ``sum_gram`` over the map, shifted by ``s``, the mean of the
    first rows: with ``S = sum(x - s)`` and ``G = (x - s)^T (x - s)``,
    ``mean = s + S/P`` and ``cov = (G - S S^T / P) / (P - 1)``, which is the
    centred covariance exactly in exact arithmetic. Without the shift the
    float32 Gram of a multi-megapixel map cancels against ``P mean mean^T``.

    A map of one pixel (a 16x16 image reaches relu5_1 at 1x1) has no
    covariance: it is 0/0 = NaN, as in the reference, which then stylizes
    to an all-NaN image.
    """
    c = feat.shape[-1]
    x = feat.reshape(-1, c).float().contiguous()
    shift = gram_shift(x)
    s, g = shifted_sum_gram(x, shift)
    return stats_from_sums(shift, s, g, x.shape[0])


def gram_shift(x: torch.Tensor) -> torch.Tensor:
    """The Gram's shift for a (P, C) map: the mean of its first rows."""
    return x[:_SHIFT_ROWS].mean(0)


def shifted_sum_gram(x: torch.Tensor, shift: torch.Tensor):
    """``(sum(x - shift), (x - shift)^T (x - shift))`` of a contiguous (P, C)
    matrix: the ``sum_gram`` kernel on the card, its plain version on the CPU."""
    if on_card(x):
        return _kstats.sum_gram(x, shift)
    return _kstats.sum_gram_plain(x, shift)


def stats_from_sums(shift: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                    p: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, cov) of ``p`` pixels from their shifted sum ``s`` and Gram
    ``g`` (sums that may have been added up over slabs, one shift for all)."""
    d = s / p
    mean = shift + d
    cov = (g - p * torch.outer(d, d)) / (p - 1)
    return mean, cov


def _eigh(covs: torch.Tensor, eps: float):
    """``(lam, v, poison)`` of a (B, C, C) stack of covariances: each with
    its non-finite entries zeroed and ``eps`` added to its diagonal,
    decomposed (eigenvalues ascending), and a (B,) factor, NaN where the
    matrix had a non-finite entry and 1 elsewhere: ``torch.linalg.eigh``
    raises on such a matrix, and the kernel is only ever given finite ones.
    The kernel takes the whole stack in one launch where it lies on the
    card, is float32 and C <= ``sym_eigh``'s limit; otherwise the library,
    one matrix a call. No host sync either way on the kernel's path."""
    c = covs.shape[-1]
    finite = torch.isfinite(covs)
    poison = torch.where(finite.flatten(1).all(1), 1.0, float("nan")).to(covs.dtype)
    covs = torch.where(finite, covs, 0.0)
    covs = covs + eps * torch.eye(c, dtype=covs.dtype, device=covs.device)
    with span("cd.eigh"):
        if on_card(covs) and covs.dtype == torch.float32 and c <= _keigh.MAX_N:
            EIGH["kernel"] += covs.shape[0]
            lam, v, _ = _keigh.sym_eigh(covs.contiguous())
        else:
            EIGH["library"] += covs.shape[0]
            lam, v = zip(*(torch.linalg.eigh(a) for a in covs))
    return lam, v, poison


def _root(lam: torch.Tensor, v: torch.Tensor, poison: torch.Tensor, *, inverse: bool,
          eps: float, truncate: float) -> torch.Tensor:
    """``cov^-1/2`` (``inverse``) or ``cov^1/2`` from one decomposition:
    eigenvalues at or below ``truncate * lambda_max`` are dropped rather
    than inverted (the reference's rank cutoff, util_wct.py:25/82-89)."""
    lam_max = torch.clamp(lam[-1], min=eps)
    keep = lam > truncate * lam_max
    s = torch.rsqrt(torch.clamp(lam, min=1e-30)) if inverse else torch.sqrt(
        torch.clamp(lam, min=0.0))
    s = torch.where(keep, s, torch.zeros_like(lam))
    return ((v * s[None, :]) @ v.T) * poison


def matrix_isqrt_sqrt_eigh(cov: torch.Tensor, *, eps: float = 1e-8,
                           truncate: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """(cov^-1/2, cov^1/2) via symmetric eigendecomposition.

    Eigenvalues at or below ``truncate * lambda_max`` are dropped rather than
    inverted (the reference's rank cutoff, util_wct.py:25/82-89).

    A covariance with a non-finite entry (the 0/0 of a one-pixel map) gives
    all-NaN roots, as ``jnp.linalg.eigh`` does; ``torch.linalg.eigh`` raises
    on such a matrix, so it gets zeros in their place and the roots are
    multiplied by NaN after, with no host sync.
    """
    (lam,), (v,), poison = _eigh(cov[None], eps)
    kw = dict(eps=eps, truncate=truncate)
    return (_root(lam, v, poison[0], inverse=True, **kw),
            _root(lam, v, poison[0], inverse=False, **kw))


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
        # both decompositions at once: one kernel launch of two blocks on the card
        lam, v, poison = _eigh(torch.stack([c_cov, s_cov]), eps)
        kw = dict(eps=eps, truncate=1e-8)
        c_isqrt = _root(lam[0], v[0], poison[0], inverse=True, **kw)
        s_sqrt = _root(lam[1], v[1], poison[1], inverse=False, **kw)
    elif method == "newton":
        c_isqrt, _ = matrix_isqrt_sqrt_newton(c_cov, eps=eps, iters=newton_iters)
        _, s_sqrt = matrix_isqrt_sqrt_newton(s_cov, eps=eps, iters=newton_iters)
    else:
        raise ValueError(f"unknown WCT method {method!r}")
    return s_sqrt @ c_isqrt


def alpha_on(alpha, device) -> torch.Tensor:
    """``alpha`` as a float32 operand of work on ``device``: a number, or a
    host tensor, as a host scalar (the card's kernels take it as an
    argument: no copy, no wait), a device tensor on ``device``."""
    a = torch.as_tensor(alpha, dtype=torch.float32)
    return a if a.device.type == "cpu" else a.to(device)


def _wct_single(content_feat, style_mean, style_cov, alpha, *, method, eps,
                newton_iters):
    """The WCT of one image in float32, returned in the content's dtype."""
    shape = content_feat.shape
    c = shape[-1]
    x = content_feat.reshape(-1, c).float()
    c_mean, c_cov = feature_stats(x)
    t = coloring_matrix(c_cov, style_cov.float(), method=method, eps=eps,
                        newton_iters=newton_iters)
    # target = T @ (x - c_mean) + s_mean, applied row-wise: (P,C) @ T^T
    target = (x - c_mean) @ t.T + style_mean.float()
    alpha = alpha_on(alpha, x.device)
    out = alpha * target + (1.0 - alpha) * x
    return out.reshape(shape).to(content_feat.dtype)


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


def wct_apply_folded(x: torch.Tensor, t: torch.Tensor, c_mean: torch.Tensor,
                     s_mean: torch.Tensor, alpha) -> torch.Tensor:
    """The whole WCT of ``x`` (..., C) as one affine map (the reference's
    ``models/packed_vgg.py:packed_wct_apply`` at ``f == 1``)::

        alpha ((x - c_mean) T^T + s_mean) + (1 - alpha) x = x M + beta,
        M = alpha T^T + (1 - alpha) I,  beta = alpha (s_mean - c_mean T^T)

    ``M`` and ``beta`` are formed in float32 and applied by the
    ``conv1x1_bias`` kernel on the card, its plain version on the CPU. A
    bfloat16 ``x`` takes ``M`` in bf16 and ``beta`` in float32 and gives
    bf16 (the reference's ``packed_wct_apply`` in its bf16 engine)."""
    c = t.shape[0]
    a = alpha_on(alpha, x.device)
    tt = t.float().T
    m = (a * tt + (1.0 - a) * torch.eye(c, dtype=torch.float32, device=x.device)).contiguous()
    beta = (a * (s_mean.float() - c_mean.float() @ tt)).contiguous()
    if x.dtype == torch.bfloat16:
        m = m.to(torch.bfloat16)
    else:
        x = x.float()
    x = x.contiguous()
    if on_card(x):
        return _k1x1.conv1x1_bias(x, m, beta, False)
    return _k1x1.conv1x1_plain(x, m, beta, False)
