"""The slice as a whole: the PyTorch port's ``WCTEngine(mode="16x")`` against
the reference engine on the CPU, on real photo content.

Whole-cascade parity is read against the float32 reordering floor: two f32
cascades that differ only in operation order agree to ~43.5 dB on real
content (README "cascade sensitivity study"; on noise eigh rotations drop it
to ~27 dB), so the bar is PSNR >= 40 dB on the docs/examples photo pair.
"""

import os

import numpy as np
import pytest
from PIL import Image

import jax

from collaborative_distillation_tpu.models.zoo import load_pyramid as jax_load_pyramid
from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine

import torch

from collaborative_distillation_tpu_torch.utils.params import pyramid_from_jax
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "docs", "examples")
PSNR_MIN_DB = 40.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _photo(name, size):
    im = Image.open(os.path.join(EXAMPLES, name)).convert("RGB")
    return np.asarray(im.resize((size, size), Image.BICUBIC), np.float32) / 255.0


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2))


@pytest.fixture(scope="module")
def pair():
    return _photo("in1+in1_16x.jpg", 256), _photo("in3+in2_16x.jpg", 256)


@pytest.fixture(scope="module")
def jax_engine(weights_root):
    return JaxEngine(mode="16x", weights_root=weights_root)


@pytest.fixture(scope="module")
def port_engine(jax_engine):
    pyr = {k: {**v, "enc": jax.tree.map(np.asarray, v["enc"]),
               "dec": jax.tree.map(np.asarray, v["dec"])}
           for k, v in jax_engine.pyramid.items()}
    return WCTEngine(mode="16x", pyramid=pyramid_from_jax(pyr), device="cpu")


def test_stylize_matches_reference_on_photos(pair, jax_engine, port_engine):
    c, s = pair
    want = jax_engine.stylize(c, s, alpha=1.0)
    got = port_engine.stylize(c, s, alpha=1.0)
    assert got.shape == c.shape and got.dtype == np.float32
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    assert _psnr(got, want) >= PSNR_MIN_DB
    assert np.abs(got - c).mean() > 0.05  # the content really was restyled


def test_engine_loads_its_own_weights(pair, weights_root, port_engine):
    """mode="16x" from the weight store gives what the carried-over pyramid gives."""
    c, s = pair
    own = WCTEngine(mode="16x", weights_root=weights_root, device="cpu")
    np.testing.assert_array_equal(own.stylize(c[:64, :64], s[:64, :64]),
                                  port_engine.stylize(c[:64, :64], s[:64, :64]))


def test_odd_shape_returns_input_shape(pair, jax_engine, port_engine):
    """Reflect-pad to a multiple of 16, crop back after the cascade."""
    c, s = pair
    c, s = c[:70, :93], s[:45, :61]
    got = port_engine.stylize(c, s)
    assert got.shape == (70, 93, 3)
    assert _psnr(got, jax_engine.stylize(c, s)) >= PSNR_MIN_DB


@pytest.mark.parametrize("method", ["eigh", "newton"])
def test_stage_subset_and_method_match_reference(pair, weights_root, method):
    c, s = (a[:64, :64] for a in pair)
    stages = (3, 2, 1)
    jp = jax_load_pyramid("16x", weights_root, stages=stages)
    pyr = pyramid_from_jax({k: {**v, "enc": jax.tree.map(np.asarray, v["enc"]),
                                "dec": jax.tree.map(np.asarray, v["dec"])}
                            for k, v in jp.items()})
    want = JaxEngine(mode="16x", pyramid=jp, stages=stages, method=method).stylize(c, s, 0.7)
    got = WCTEngine(pyramid=pyr, stages=stages, method=method, device="cpu").stylize(c, s, 0.7)
    assert _psnr(got, want) >= PSNR_MIN_DB
