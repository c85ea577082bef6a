"""WCT math of the PyTorch port against the reference package, on the CPU.

Statistics and single products are held near float32 epsilon (relative
2e-5 of the largest entry, as sums of thousands of terms in another order);
the matrix square roots go through two different LAPACK eigensolver calls
(or 24 Newton-Schulz steps), so they are held to 1e-4 relative to their
largest entry.
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp

import torch

from collaborative_distillation_tpu_torch.ops import wct_transform as tw

# the reference package's ops/__init__ re-exports the function under the
# module's name, so take the module itself
jw = importlib.import_module("collaborative_distillation_tpu.ops.wct_transform")


def _feat(rng, p, c, offset=3.0):
    mix = rng.standard_normal((c, c)).astype(np.float32) / np.sqrt(c)
    return (rng.standard_normal((p, c)).astype(np.float32) @ mix + offset
            + rng.standard_normal(c).astype(np.float32))


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


def _spd(rng, c, cond=1e3):
    q = np.linalg.qr(rng.standard_normal((c, c)))[0]
    lam = np.geomspace(1.0, 1.0 / cond, c)
    return ((q * lam) @ q.T).astype(np.float32)


@pytest.mark.parametrize("shape", [(1000, 24), (5000, 64), (37, 128), (2, 16)], ids=str)
def test_feature_stats_matches_reference(rng, shape):
    x = _feat(rng, *shape)
    m, c = tw.feature_stats(torch.from_numpy(x))
    jm, jc = jw.feature_stats(jnp.asarray(x))
    _close(m.numpy(), jm, 2e-5)
    _close(c.numpy(), jc, 2e-5)


def test_feature_stats_shift_is_exact_against_float64(rng):
    """The shifted Gram (mean of the first rows as the shift) recovers the
    centred covariance of a map whose mean dwarfs its spread."""
    x = (rng.standard_normal((20000, 16)) * 0.5 + 100.0).astype(np.float32)
    m, c = tw.feature_stats(torch.from_numpy(x).reshape(100, 200, 16))
    x64 = x.astype(np.float64)
    _close(m.numpy(), x64.mean(0), 1e-6)
    _close(c.numpy(), np.cov(x64, rowvar=False), 1e-4)


def test_feature_stats_refuses_one_pixel(rng):
    """A one-pixel map (a 16x16 image at relu5_1) has no covariance: the port
    gives what the reference gives, the pixel as the mean and 0/0 = NaN as
    the covariance, and its eigh route turns that into NaN roots without
    raising, as jnp.linalg.eigh does."""
    x = rng.standard_normal((1, 1, 1, 8)).astype(np.float32)
    m, c = tw.feature_stats(torch.from_numpy(x))
    jm, jc = jw.feature_stats(jnp.asarray(x))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert np.isnan(c.numpy()).all() and np.isnan(np.asarray(jc)).all()
    for method in ("eigh", "newton"):
        t = tw.coloring_matrix(c, torch.eye(8), method=method)
        jt = jw.coloring_matrix(jc, jnp.eye(8), method=method)
        assert np.isnan(t.numpy()).all() and np.isnan(np.asarray(jt)).all()


@pytest.mark.parametrize("c", [16, 64])
def test_matrix_roots_match_reference(rng, c):
    cov = _spd(rng, c)
    for t_fn, j_fn in [(tw.matrix_isqrt_sqrt_eigh, jw.matrix_isqrt_sqrt_eigh),
                       (tw.matrix_isqrt_sqrt_newton, jw.matrix_isqrt_sqrt_newton)]:
        ti, ts = t_fn(torch.from_numpy(cov))
        ji, js = j_fn(jnp.asarray(cov))
        _close(ti.numpy(), ji, 1e-4)
        _close(ts.numpy(), js, 1e-4)


def test_lambda_max_estimate_matches_reference(rng):
    cov = _spd(rng, 32, cond=1e2)
    got = float(tw._lambda_max_estimate(torch.from_numpy(cov)))
    want = float(jw._lambda_max_estimate(jnp.asarray(cov)))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("method", ["eigh", "newton"])
def test_rank_deficient_covariance_matches_reference(rng, method):
    """The reference's pinned rank-deficient case (tests/test_wct.py): rank 6
    in 32 channels. The port's coloring matrix stays finite and whitens the
    row space to ~identity, like the reference's."""
    c, r, p = 32, 6, 4000
    basis = np.linalg.qr(rng.standard_normal((c, r)))[0].astype(np.float32)
    x = (rng.standard_normal((p, r)).astype(np.float32) * 5.0) @ basis.T
    mean, cov = tw.feature_stats(torch.from_numpy(x))
    t = tw.coloring_matrix(cov, torch.eye(c), method=method).numpy()
    assert np.isfinite(t).all()
    w = (x - mean.numpy()) @ t.T
    lam = np.sort(np.linalg.eigvalsh(w.T @ w / (p - 1)))
    np.testing.assert_allclose(lam[-r:], 1.0, atol=0.1)
    assert lam[:-r].max() < 0.15
    # and the port's whitened data agrees with the reference's on the row space
    jm, jc = jw.feature_stats(jnp.asarray(x))
    jt = np.asarray(jw.coloring_matrix(jc, jnp.eye(c), method=method))
    jwh = (x - np.asarray(jm)) @ jt.T
    _close(w @ basis, jwh @ basis, 1e-3)


@pytest.mark.parametrize("method", ["eigh", "newton"])
def test_coloring_matrix_matches_reference(rng, method):
    cc, sc = _spd(rng, 24), _spd(rng, 24, cond=1e2)
    t = tw.coloring_matrix(torch.from_numpy(cc), torch.from_numpy(sc), method=method)
    j = jw.coloring_matrix(jnp.asarray(cc), jnp.asarray(sc), method=method)
    _close(t.numpy(), j, 1e-4)
    with pytest.raises(ValueError):
        tw.coloring_matrix(torch.from_numpy(cc), torch.from_numpy(sc), method="svd")


def _style(rng, c, n=None):
    s = [_feat(rng, 900, c, offset=1.0) for _ in range(n or 1)]
    stats = [jw.feature_stats(jnp.asarray(a)) for a in s]
    m = np.stack([np.asarray(a) for a, _ in stats])
    cv = np.stack([np.asarray(b) for _, b in stats])
    return (m, cv) if n else (m[0], cv[0])


@pytest.mark.parametrize("alpha", [1.0, 0.6, 0.0])
def test_wct_transform_single_matches_reference(rng, alpha):
    x = _feat(rng, 400, 32).reshape(1, 20, 20, 32)
    sm, sc = _style(rng, 32)
    got = tw.wct_transform(torch.from_numpy(x), torch.from_numpy(sm), torch.from_numpy(sc),
                           alpha)
    want = jw.wct_transform(jnp.asarray(x), jnp.asarray(sm), jnp.asarray(sc), alpha)
    _close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("per_image", [False, True])
def test_wct_transform_batch_semantics_match_reference(rng, per_image):
    """N > 1 whitens each image with its own statistics; style stats shared
    ((C,), (C,C)) or per image ((N,C), (N,C,C))."""
    x = np.stack([_feat(rng, 144, 16, offset=o) for o in (0.0, 5.0)]).reshape(2, 12, 12, 16)
    sm, sc = _style(rng, 16, n=2 if per_image else None)
    got = tw.wct_transform(torch.from_numpy(x), torch.from_numpy(sm), torch.from_numpy(sc))
    want = jw.wct_transform(jnp.asarray(x), jnp.asarray(sm), jnp.asarray(sc))
    _close(got.numpy(), want, 1e-4)
    # each image alone gives the same answer as in the batch
    one = tw.wct_transform(torch.from_numpy(x[1:]),
                           torch.from_numpy(sm[1:] if per_image else sm),
                           torch.from_numpy(sc[1:] if per_image else sc))
    _close(got.numpy()[1:], one.numpy(), 1e-5)


def test_wct_transform_newton_matches_reference(rng):
    x = _feat(rng, 256, 16).reshape(1, 16, 16, 16)
    sm, sc = _style(rng, 16)
    got = tw.wct_transform(torch.from_numpy(x), torch.from_numpy(sm), torch.from_numpy(sc),
                           0.8, method="newton")
    want = jw.wct_transform(jnp.asarray(x), jnp.asarray(sm), jnp.asarray(sc), 0.8,
                            method="newton")
    _close(got.numpy(), want, 1e-4)
