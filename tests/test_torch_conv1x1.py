"""The port's ``conv1x1_bias`` (plain version, on the CPU) and its folded WCT
apply against the reference package's Pallas ``conv1x1_lane128`` in
interpret mode and its ``packed_wct_apply``.

Inputs come from numpy with a seed and go unchanged to both sides. The 1x1
conv is held to 1e-5 of its partial-sum scale ``max|x| * max_co sum|W| +
max|b|`` (both sides sum up to 128 float32 products in another order); the
folded apply to 1e-5 relative to its largest output.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from collaborative_distillation_tpu.models.packed_vgg import packed_wct_apply
from collaborative_distillation_tpu.ops.pallas.conv import conv1x1_lane128

import torch

from collaborative_distillation_tpu_torch.ops import wct_transform as tw
from collaborative_distillation_tpu_torch.ops.cuda import conv1x1 as k1x1

WIDTHS = [24, 32, 64, 128]


def _inputs(rng, cin, cout, h=8, w=16):
    x = rng.standard_normal((h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, wt, b


@pytest.mark.parametrize("cin", WIDTHS)
@pytest.mark.parametrize("cout", WIDTHS)
@pytest.mark.parametrize("relu", [True, False])
def test_conv1x1_matches_pallas_lane128(rng, cin, cout, relu):
    x, wt, b = _inputs(rng, cin, cout)
    got = k1x1.conv1x1_plain(torch.from_numpy(x), torch.from_numpy(wt),
                             torch.from_numpy(b), relu).numpy()
    want = np.asarray(conv1x1_lane128(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                                      relu=relu, block_h=4, block_w=8, interpret=True))
    scale = np.abs(x).max() * np.abs(wt).sum(0).max() + np.abs(b).max()
    assert got.shape == want.shape == (8, 16, cout)
    assert np.abs(got - want).max() <= 1e-5 * scale


def test_conv1x1_without_bias_matches_pallas_lane128(rng):
    x, wt, _ = _inputs(rng, 64, 24)
    got = k1x1.conv1x1_plain(torch.from_numpy(x).reshape(-1, 64), torch.from_numpy(wt),
                             None, False).numpy()
    want = np.asarray(conv1x1_lane128(jnp.asarray(x), jnp.asarray(wt), None,
                                      block_h=8, interpret=True)).reshape(-1, 24)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(x).max() * np.abs(wt).sum(0).max()


def _wct_inputs(rng, c):
    x = (rng.standard_normal((1, 6, 10, c)) * 2 + 1).astype(np.float32)
    q = np.linalg.qr(rng.standard_normal((c, c)))[0]
    t = ((q * np.geomspace(2.0, 0.1, c)) @ q.T).astype(np.float32)
    c_mean = rng.standard_normal(c).astype(np.float32)
    s_mean = rng.standard_normal(c).astype(np.float32)
    return x, t, c_mean, s_mean


@pytest.mark.parametrize("c", [24, 64, 128])
@pytest.mark.parametrize("alpha", [0.0, 0.6, 1.0])
def test_wct_apply_folded_matches_packed_wct_apply(rng, c, alpha):
    x, t, cm, sm = _wct_inputs(rng, c)
    got = tw.wct_apply_folded(*map(torch.from_numpy, (x, t, cm, sm)), alpha).numpy()
    want = np.asarray(packed_wct_apply(jnp.asarray(x), 1, c, jnp.asarray(t),
                                       jnp.asarray(cm), jnp.asarray(sm), alpha))
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_wct_apply_folded_is_the_wct_blend(rng):
    """x M + beta is alpha ((x - c_mean) T^T + s_mean) + (1 - alpha) x."""
    x, t, cm, sm = _wct_inputs(rng, 32)
    got = tw.wct_apply_folded(*map(torch.from_numpy, (x, t, cm, sm)),
                              torch.tensor(0.3)).numpy()
    x64 = x.astype(np.float64)
    want = 0.3 * ((x64 - cm) @ t.T.astype(np.float64) + sm) + 0.7 * x64
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
