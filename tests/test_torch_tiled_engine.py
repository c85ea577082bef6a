"""The port engine's ``space`` + ``slab_rows`` routing
(``WCTEngine(space=4, slab_rows=..., devices=["cpu"] * 4)``) against the
reference engine's on the virtual CPU mesh and against the port's
single-device slab engine, with the toy pyramid and images of
tests/test_tiled_slab.py; atol 3e-3, the reference's own bar between its
sharded and single-chip slab cascades.
"""

import numpy as np
import pytest

import jax

from collaborative_distillation_tpu.models.specs import decoder_spec, encoder_spec
from collaborative_distillation_tpu.models.vgg import init_params
from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine

import torch

from collaborative_distillation_tpu_torch.utils.params import pyramid_from_jax
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

STAGES = (3, 2, 1)
ATOL = 3e-3


def _np_tree(pyr):
    return {k: {**v, "enc": jax.tree.map(np.asarray, v["enc"]),
                "dec": jax.tree.map(np.asarray, v["dec"])} for k, v in pyr.items()}


def _toy_pyramid(stages, seed):
    key = jax.random.key(seed)
    pyr = {}
    for s in stages:
        key, k1, k2 = jax.random.split(key, 3)
        espec, dspec = encoder_spec("16x", s, aux=True), decoder_spec("16x", s)
        pyr[s] = {"enc_spec": espec, "dec_spec": dspec,
                  "enc": init_params(espec, k1), "dec": init_params(dspec, k2)}
    return pyr


@pytest.fixture(scope="module")
def pyramids():
    jp = _toy_pyramid(STAGES, 7)
    return jp, pyramid_from_jax(_np_tree(jp))


@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(0)
    return rng.random((1, 192, 48, 3), np.float32), rng.random((1, 64, 48, 3), np.float32)


@pytest.fixture(scope="module")
def engines(pyramids):
    jp, tp = pyramids
    je = JaxEngine(mode="16x", pyramid=jp, stages=STAGES, space=4, slab_rows=48, packed=False)
    te = WCTEngine(pyramid=tp, stages=STAGES, device="cpu", space=4, slab_rows=48,
                   devices=["cpu"] * 4)
    return je, te


def test_engine_awkward_height_pads_and_crops(engines, imgs):
    je, te = engines
    assert te._tiled_slab == je._tiled_slab > 0 and te.slab is None
    c, s = imgs[0][0, :150], imgs[1][0]   # 150 rows pad to 160, then to slab * space
    want = je.stylize(c, s, alpha=0.9)
    got = te.stylize(c, s, alpha=0.9)
    assert got.shape == want.shape == c.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_engine_cached_style_key_matches_single_device_slab_engine(engines, pyramids, imgs):
    _, te = engines
    _, tp = pyramids
    c, s = imgs[0][0], imgs[1][0]
    single = WCTEngine(pyramid=tp, stages=STAGES, device="cpu", slab_rows=te._tiled_slab)
    ref = single.stylize(c, s, alpha=0.8, style_key="k")
    out1 = te.stylize(c, s, alpha=0.8, style_key="k")
    assert (1, "k", (1, 64, 48, 3)) in te._style_cache
    out2 = te.stylize(c, s, alpha=0.8, style_key="k")   # cached statistics
    np.testing.assert_array_equal(out1, out2)
    np.testing.assert_allclose(out1, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(te.stylize(c, s, alpha=0.8, num_run=2),
                               single.stylize(c, s, alpha=0.8, num_run=2), atol=ATOL, rtol=0)
    # a blend of styles reaches the shards as statistics under the blend's
    # key: weights [1, 0] reduce to the first style's
    np.testing.assert_allclose(te.stylize_multi(c, [s, s[::-1].copy()], [1.0, 0.0], alpha=0.8),
                               out1, atol=1e-5, rtol=0)


def test_engine_refuses_batches_and_too_few_devices(engines, pyramids, imgs):
    je, te = engines
    _, tp = pyramids
    cb, sb = np.concatenate([imgs[0]] * 2), np.concatenate([imgs[1]] * 2)
    for eng in (je, te):
        with pytest.raises(ValueError, match="per-image"):
            eng.stylize(cb, sb, alpha=0.9)
    if not torch.cuda.is_available():
        # no device list: the shards want one CUDA device each, and the engine
        # neither moves to the CPU nor doubles up on a device unasked
        with pytest.raises(ValueError, match="needs 4 devices, have 0"):
            WCTEngine(pyramid=tp, stages=STAGES, device="cpu", space=4, slab_rows=48)
