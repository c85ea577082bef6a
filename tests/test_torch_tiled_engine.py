"""The port engine's ``space`` + ``slab_rows`` routing
(``WCTEngine(space=4, slab_rows=..., devices=["cpu"] * 4)``) against the
reference engine's on the virtual CPU mesh and against the port's
single-device slab engine, with the toy pyramid and images of
tests/test_tiled_slab.py; atol 3e-3, the reference's own bar between its
sharded and single-chip slab cascades. At heights that are no multiple of
slab_rows * space the reference pads with mirrored rows that enter its
statistics; the port deals whole windows of the single-card plan to the
shards and is held to the plain engine there.
"""

import os

import numpy as np
import pytest

import jax

from collaborative_distillation_tpu.models.specs import decoder_spec, encoder_spec
from collaborative_distillation_tpu.models.vgg import init_params
from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine

import torch

from collaborative_distillation_tpu_torch.parallel import spatial as tsp
from collaborative_distillation_tpu_torch.utils.params import pyramid_from_jax
from collaborative_distillation_tpu_torch.wct import slab as tslab
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

STAGES = (3, 2, 1)
ATOL = 3e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2))


def test_engine_awkward_height_pads_and_crops(engines, pyramids, imgs):
    je, te = engines
    jp, _ = pyramids
    assert te._tiled_slab == je._tiled_slab > 0 and te.slab is None
    c, s = imgs[0][0, :150], imgs[1][0]   # 150 rows pad to 160, and no further
    want = JaxEngine(mode="16x", pyramid=jp, stages=STAGES, packed=False).stylize(
        c, s, alpha=0.9)
    got = te.stylize(c, s, alpha=0.9)
    assert got.shape == want.shape == c.shape and np.isfinite(got).all()
    assert _psnr(got, want) >= 40.0


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


@pytest.mark.parametrize("slab_rows", [288, 512])
@pytest.mark.parametrize("space", [2, 4, 8])
def test_shards_take_whole_windows_of_the_single_card_plan(slab_rows, space):
    """At every height from 288 to 2000 rows in steps of 16: the shards' rows
    (``shard_rows``) hold whole windows of the single-card plan in order,
    the remainder with the last whole one; mapped back to the image, each
    live shard's windows (``slab_coords`` in the halo-extended shard) are
    that plan's windows, read only the shard and its neighbours' ``2m``
    halo rows, never a global edge's zero fill; trailing shards without a
    window hold no rows."""
    pyr = {k: {"enc_spec": encoder_spec("16x", k, aux=True),
               "dec_spec": decoder_spec("16x", k)} for k in (5, 4, 3, 2, 1)}
    cas = tslab.SlabCascade(pyr, slab_rows=slab_rows)
    for h in range(288, 2001, 16):
        rows = tsp.shard_rows(h, slab_rows, space)
        live = [d for d in range(space) if rows[d]]
        assert live == list(range(len(live)))   # trailing shards sit out
        assert sum(rows) == h and all(rows[d] % slab_rows == 0 for d in live[:-1])
        if len(live) == 1:
            continue   # one shard holds the image: the single-card plan itself
        assert all(rows[d] >= slab_rows for d in live)
        for k in (5, 4, 3, 2, 1):
            m = cas.margins[k]
            hm = 2 * m
            got, a = [], 0
            for j, d in enumerate(live):
                for i in range(-(-rows[d] // slab_rows)):
                    start, off = tsp.slab_coords(i, slab=slab_rows, m=m, hm=hm,
                                                 h_loc=rows[d], is_first=j == 0,
                                                 is_last=j == len(live) - 1)
                    assert 0 <= start and start + slab_rows + hm <= rows[d] + 2 * hm
                    assert not (j == 0 and start < hm)
                    assert not (j == len(live) - 1 and start + slab_rows + hm > rows[d] + hm)
                    got.append((a + start - hm, slab_rows + hm, off,
                                min(slab_rows, rows[d] - i * slab_rows)))
                a += rows[d]
            assert got == list(cas._slabs(h, k))


@pytest.fixture(scope="module")
def photo(weights_root):
    """The shipped 16x pyramid (through the reference's loader), the photo
    pair's content mirrored to 1024 rows, 256 wide, and a 128^2 style."""
    from collaborative_distillation_tpu.models.zoo import load_pyramid
    jp = load_pyramid("16x", weights_root)
    with np.load(os.path.join(os.path.dirname(tslab.__file__), os.pardir, "data",
                              "photo_pair_512.npz")) as d:
        c, s = d["content"], d["style"]
    c = np.concatenate([c, c[::-1]])[:, :256].astype(np.float32) / 255.0
    tp = pyramid_from_jax(_np_tree(jp))
    return tp, c, s[:128, :128].astype(np.float32) / 255.0, {}


@pytest.mark.parametrize("h", [704, 1000])
@pytest.mark.parametrize("space", [2, 4])
def test_sharded_engine_matches_plain_engine_at_awkward_heights(photo, space, h):
    """No slab * space multiple: whole windows per shard, nothing padded,
    so the sharded cascade is the plain one up to float32 order (the
    shards' sums are added shard by shard)."""
    tp, c, s, plain = photo
    if h not in plain:
        plain[h] = WCTEngine(pyramid=tp, device="cpu").stylize(c[:h], s)
    eng = WCTEngine(pyramid=tp, device="cpu", space=space, slab_rows=288,
                    devices=["cpu"] * space)
    got = eng.stylize(c[:h], s)
    assert got.shape == plain[h].shape == (h, 256, 3)
    assert _psnr(got, plain[h]) >= 80.0
