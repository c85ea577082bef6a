"""Photo-WCT in the PyTorch port, on the CPU, against the reference package's
functions of the same names (tests/test_ops.py, tests/test_models.py and
tests/test_engine.py::test_engine_pwct_path hold the reference itself):

* ``max_pool_2x2_with_argmax`` and ``max_unpool_2x2``: exact (a maximum, its
  first index, and copies), with ties and odd sizes;
* ``apply_encoder(with_pool_argmax=True)`` and ``apply_decoder_pwct`` at
  stage 3: 1e-5 relative to the largest output (float32 convs in another
  order); the argmax maps equal;
* ``WCTEngine.stylize(pwct=True)`` on a 256^2 crop of the photo pair: PSNR
  >= 40 dB, under the 43.5 dB float32 reordering floor of real content;
* the refusals: slab and sharded engines, and the endpoints that the
  reference runs without photo-WCT.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from collaborative_distillation_tpu.models.specs import decoder_spec as jax_decoder_spec
from collaborative_distillation_tpu.models.specs import encoder_spec as jax_encoder_spec
from collaborative_distillation_tpu.models.vgg import apply_decoder_pwct as jax_decoder_pwct
from collaborative_distillation_tpu.models.vgg import apply_encoder as jax_apply_encoder
from collaborative_distillation_tpu.models.vgg import init_params as jax_init_params
from collaborative_distillation_tpu.ops.conv import max_pool_2x2_with_argmax as jax_pool_argmax
from collaborative_distillation_tpu.ops.conv import max_unpool_2x2 as jax_unpool
from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine

import torch

from collaborative_distillation_tpu_torch.models.vgg import apply_decoder_pwct, apply_encoder
from collaborative_distillation_tpu_torch.ops.conv import (max_pool_2x2,
                                                            max_pool_2x2_with_argmax,
                                                            max_unpool_2x2)
from collaborative_distillation_tpu_torch.utils.params import (params_from_jax,
                                                               pyramid_from_jax, spec_from_jax)
from collaborative_distillation_tpu_torch.wct import slab as tslab
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

PSNR_MIN_DB = 40.0
REFUSAL = "pwct=True is only supported on the plain per-stage path"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2))


def _np_tree(pyr):
    return {k: {**v, "enc": jax.tree.map(np.asarray, v["enc"]),
                "dec": jax.tree.map(np.asarray, v["dec"])} for k, v in pyr.items()}


@pytest.mark.parametrize("shape", [(1, 8, 6, 5), (2, 7, 9, 3), (1, 1, 5, 4), (1, 9, 1, 2)],
                         ids=str)
@pytest.mark.parametrize("values", ["ties", "relu", "continuous"])
def test_pool_argmax_and_unpool_equal_reference(rng, shape, values):
    """Ties (three levels, so most windows hold equal maxima; ReLU'd maps,
    whose all-zero windows pick index 0) go to the first maximum in both;
    an odd last row or column is dropped by the pool and zero-filled by the
    unpool to the input's size."""
    x = rng.standard_normal(shape).astype(np.float32)
    if values == "ties":
        x = rng.integers(0, 3, shape).astype(np.float32)
    elif values == "relu":
        x = np.maximum(x, 0)
    pooled, idx = max_pool_2x2_with_argmax(torch.from_numpy(x))
    j_pooled, j_idx = jax_pool_argmax(jnp.asarray(x))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(pooled.numpy(), np.asarray(j_pooled))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(pooled.numpy(), max_pool_2x2(torch.from_numpy(x)).numpy())
    out_hw = shape[1:3]
    un = max_unpool_2x2(pooled, idx, out_hw)
    assert un.shape == shape
    np.testing.assert_array_equal(un.numpy(), np.asarray(jax_unpool(j_pooled, j_idx, out_hw)))
    # every pooled value stands at its window's first maximum, zeros elsewhere
    assert float(un.sum()) == pytest.approx(float(pooled.sum()), rel=1e-6)


def test_first_maximum_of_a_tied_window():
    x = torch.tensor([[[[1.0], [2.0]], [[2.0], [2.0]]]])   # (1, 2, 2, 1)
    pooled, idx = max_pool_2x2_with_argmax(x)
    assert float(pooled) == 2.0 and int(idx) == 1   # dy=0, dx=1 comes first
    un = max_unpool_2x2(pooled, idx, (3, 3))
    np.testing.assert_array_equal(un[0, :, :, 0].numpy(), [[0, 2, 0], [0, 0, 0], [0, 0, 0]])


def test_stage3_encoder_with_argmax_and_pwct_decoder_equal_reference(rng):
    jes, jds = jax_encoder_spec("16x", 3, aux=True), jax_decoder_spec("16x", 3)
    jenc = jax_init_params(jes, jax.random.key(3))
    jdec = jax_init_params(jds, jax.random.key(4))
    enc, dec = (params_from_jax(jax.tree.map(np.asarray, p)) for p in (jenc, jdec))
    es, ds = spec_from_jax(jes), spec_from_jax(jds)
    x = rng.random((1, 36, 44, 3), dtype=np.float32)
    got = apply_encoder(enc, torch.from_numpy(x), es, aux=False, with_pool_argmax=True)
    want = jax_apply_encoder(jenc, jnp.asarray(x), jes, with_pool_argmax=True)
    assert {k for k in got} == {k for k in want if not k.startswith("aux")}
    for p in (1, 2):
        assert got[f"pool{p}_hw"] == want[f"pool{p}_hw"]
        np.testing.assert_array_equal(got[f"pool{p}_idx"].numpy(),
                                      np.asarray(want[f"pool{p}_idx"]))
    scale = float(np.abs(np.asarray(want["out"])).max())
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want["out"]), rtol=0,
                               atol=1e-5 * scale)
    # the decoder on the same features and indices; no final ReLU
    feats = rng.standard_normal(np.asarray(want["out"]).shape).astype(np.float32)
    idx = {k: v for k, v in want.items() if k.startswith("pool")}
    rec = apply_decoder_pwct(dec, torch.from_numpy(feats), ds,
                             {k: torch.from_numpy(np.array(v)) if k.endswith("idx") else v
                              for k, v in idx.items()})
    j_rec = np.asarray(jax_decoder_pwct(jdec, jnp.asarray(feats), jds, idx))
    assert rec.shape == x.shape and (j_rec < 0).any()
    np.testing.assert_allclose(rec.numpy(), j_rec, rtol=0, atol=1e-5 * np.abs(j_rec).max())


@pytest.fixture(scope="module")
def engines(weights_root):
    jax_engine = JaxEngine(mode="16x", weights_root=weights_root)
    port = WCTEngine(mode="16x", pyramid=pyramid_from_jax(_np_tree(jax_engine.pyramid)),
                     device="cpu")
    return jax_engine, port


@pytest.fixture(scope="module")
def photo():
    with np.load(os.path.join(os.path.dirname(tslab.__file__), os.pardir, "data",
                              "photo_pair_512.npz")) as d:
        return (d["content"][:256, :256].astype(np.float32) / 255.0,
                d["style"][:256, :256].astype(np.float32) / 255.0)


def test_engine_pwct_matches_reference_on_the_photo_pair(engines, photo):
    jax_engine, port = engines
    c, s = photo
    got = port.stylize(c, s, pwct=True)
    want = jax_engine.stylize(c, s, pwct=True)
    assert got.shape == c.shape and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0   # clipped after the crop
    assert _psnr(got, want) >= PSNR_MIN_DB
    plain = port.stylize(c, s)
    assert np.abs(got - plain).mean() > 0.01   # photo-WCT is another result
    # odd sizes: the odd row and column pools drop are unpooled to zeros, the
    # engine pads to 16 first, so the result has the input's shape
    odd = port.stylize(c[:70, :93], s[:45, :61], pwct=True)
    assert odd.shape == (70, 93, 3)
    assert _psnr(odd, jax_engine.stylize(c[:70, :93], s[:45, :61], pwct=True)) >= PSNR_MIN_DB


def test_pwct_keeps_the_style_statistics_and_their_cache(engines, photo):
    _, port = engines
    c, s = (a[:64, :64] for a in photo)
    first = port.stylize_device(torch.from_numpy(c), torch.from_numpy(s), pwct=True,
                                style_key="p")
    assert (1, "p", (1, 64, 64, 3)) in port._style_cache
    again = port.stylize(c, s, pwct=True, style_key="p")
    np.testing.assert_array_equal(first[0].numpy(), again)
    port.invalidate_style("p")


def test_slab_and_sharded_engines_refuse_pwct(engines, photo, weights_root):
    jax_engine, port = engines
    c, s = (a[:64, :64] for a in photo)
    pyr = port.pyramid
    slab = WCTEngine(pyramid=pyr, device="cpu", slab_rows=288)
    sharded = WCTEngine(pyramid=pyr, device="cpu", space=2, devices=["cpu"] * 2)
    tiled_slab = WCTEngine(pyramid=pyr, device="cpu", space=2, slab_rows=288,
                           devices=["cpu"] * 2)
    for eng in (slab, sharded, tiled_slab):
        with pytest.raises(ValueError, match=REFUSAL):
            eng.stylize(c, s, pwct=True)
        with pytest.raises(ValueError, match=REFUSAL):
            eng.stylize_device(torch.from_numpy(c), torch.from_numpy(s), pwct=True)
    with pytest.raises(ValueError, match=REFUSAL):
        JaxEngine(mode="16x", weights_root=weights_root, slab_rows=288).stylize(c, s, pwct=True)
    # the reference runs these with pwct=False only: no such argument here either
    y = np.zeros((64, 64), np.uint8)
    cbcr = np.zeros((32, 32, 2), np.uint8)
    for call in (lambda: port.stylize_planes(y, cbcr, s, pwct=True),
                 lambda: port.stylize_planes_jpeg(y, cbcr, s, pwct=True),
                 lambda: port.stylize_jpeg(b"", s, pwct=True),
                 lambda: next(port.stylize_pairs([(c, s)], pwct=True))):
        with pytest.raises(TypeError, match="pwct"):
            call()
