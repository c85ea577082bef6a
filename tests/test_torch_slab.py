"""The port's UHD row-slab cascade (``wct/slab.py`` and the engine's slab
routing) against the reference package's, on the CPU, on the shipped 16x
weights and the docs/examples photo pair.

The slab plan (receptive radii, margins, slab boundaries, slab sizes) is
held equal to the reference's exactly: an off-by-margin error shows as a
seam, not as a failure. Statistics are held near float32 epsilon (sums
over slabs in another order); whole cascades to PSNR >= 40 dB, the parity
bar of tests/test_torch_engine.py (the float32 reordering floor on real
content is ~43.5 dB).
"""

import os

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
from jax import lax

from collaborative_distillation_tpu.models.zoo import load_pyramid as jax_load_pyramid
from collaborative_distillation_tpu.ops import feature_stats as jax_feature_stats
from collaborative_distillation_tpu.wct import slab as jslab
from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine

import torch

from collaborative_distillation_tpu_torch.ops import wct_transform as tw
from collaborative_distillation_tpu_torch.utils.params import pyramid_from_jax
from collaborative_distillation_tpu_torch.wct import slab as tslab
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "docs", "examples")
PSNR_MIN_DB = 40.0
STAGES = (5, 4, 3, 2, 1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _photo(name, h, w):
    im = Image.open(os.path.join(EXAMPLES, name)).convert("RGB")
    return np.asarray(im.resize((w, h), Image.BICUBIC), np.float32) / 255.0


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2))


@pytest.fixture(scope="module")
def pyramids(weights_root):
    jp = jax_load_pyramid("16x", weights_root)
    np_tree = {k: {**v, "enc": jax.tree.map(np.asarray, v["enc"]),
                   "dec": jax.tree.map(np.asarray, v["dec"])} for k, v in jp.items()}
    return jp, pyramid_from_jax(np_tree)


@pytest.fixture(scope="module")
def tall():
    """A narrow 864x64 content (three 288-row slabs) and a 64x64 style."""
    return _photo("in1+in1_16x.jpg", 864, 64), _photo("in3+in2_16x.jpg", 64, 64)


# ---- (c) the slab plan equals the reference's exactly ----------------------

def test_receptive_radius_and_margins_match_reference(pyramids):
    jp, tp = pyramids
    for k in STAGES:
        for part in ("enc_spec", "dec_spec"):
            assert tslab.receptive_radius(tp[k][part]) == jslab.receptive_radius(jp[k][part])
    for stages, slab in [(STAGES, 1024), (STAGES, 288), ((2, 1), 32), ((1,), 5)]:
        want = jslab.SlabCascade(jp, stages=stages, slab_rows=slab)
        got = tslab.SlabCascade(tp, stages=stages, slab_rows=slab)
        assert got.margins == want.margins and got.margin == want.margin
        assert (got.slab_rows, got.down_max) == (want.slab_rows, want.down_max)
    assert tslab.SlabCascade(tp, slab_rows=1024).margins == {5: 144, 4: 64, 3: 32, 2: 16, 1: 16}


@pytest.mark.parametrize("stages,slab", [(STAGES, 288), (STAGES, 1024), ((2, 1), 32),
                                         ((3, 2, 1), 64)], ids=str)
def test_slab_boundaries_match_reference(pyramids, stages, slab):
    jp, tp = pyramids
    want = jslab.SlabCascade(jp, stages=stages, slab_rows=slab)
    got = tslab.SlabCascade(tp, stages=stages, slab_rows=slab)
    for n in (1, 2, 3, 4, 7):
        h = n * got.slab_rows
        for k in (None,) + stages:
            windows = list(got._slabs(h, k))
            assert [w[:3] for w in windows] == list(want._slabs(h, k))
            # at slab multiples every window's interior is one whole slab
            assert [w[3] for w in windows] == [got.slab_rows] * n


def test_pick_slab_rows_matches_reference():
    cases = [(2160, 1024, 144, 16), (4096, 1024, 144, 16), (3000, 1024, 144, 16),
             (1080, 512, 144, 16), (700, 288, 144, 16), (100, 32, 16, 2), (97, 64, 8, 4)]
    cases += [(h, 1024, 144, 16) for h in range(288, 5000, 173)]
    for args in cases:
        assert tslab.SlabCascade.pick_slab_rows(*args) == jslab.SlabCascade.pick_slab_rows(*args)
    assert tslab.SlabCascade.pick_slab_rows(2160, 1024, 144, 16) == 720


@pytest.mark.parametrize("slab_rows", [288, 512])
def test_window_plan_counts_every_row_once(pyramids, slab_rows):
    """At every height from 288 to 2000 rows in steps of 16, slab multiple
    or not, at every stage: the windows' interiors tile [0, h) in order, so
    pass 1 sums every row once and pass 2 writes every output row once;
    every window lies inside the image, keeps the ``slab + 2m`` shape (or is
    the whole image), has a margin of context on each side except at the
    image's edge, and cuts feature rows exactly."""
    _, tp = pyramids
    cas = tslab.SlabCascade(tp, slab_rows=slab_rows)
    for h in range(288, 2001, 16):
        for k in (None,) + STAGES:
            m = cas.margin if k is None else cas.margins[k]
            windows = list(cas._slabs(h, k))
            row = 0
            for start, rows, off, n in windows:
                assert start + off == row and n > 0   # pass 1 reads, pass 2 writes here
                assert 0 <= start and start + rows <= h
                assert rows == (h if len(windows) == 1 else slab_rows + 2 * m)
                assert off >= m or start == 0
                assert start + rows - (off + n) >= m or start + rows == h
                assert off % 16 == n % 16 == 0
                row += n
            assert row == h
            assert len(windows) == (1 if h < slab_rows + 2 * m else -(-h // slab_rows))


# ---- (d) slab-accumulated statistics ---------------------------------------

@pytest.mark.parametrize("k", [2, 1])
def test_slab_stats_match_reference_pass1(pyramids, k):
    jp, tp = pyramids
    x = _photo("in3+in2_16x.jpg", 128, 48)[None]
    want = jslab.SlabCascade(jp, stages=(2, 1), slab_rows=32)
    got = tslab.SlabCascade(tp, stages=(2, 1), slab_rows=32)
    down = 2 ** (k - 1)
    s1 = s2 = None
    stats = want._stats_fn(k)
    for start, rows, off in want._slabs(128, k):
        a, b = stats(jp[k]["enc"], lax.dynamic_slice_in_dim(jnp.asarray(x), start, rows,
                                                            axis=1), jnp.int32(off // down))
        s1 = a if s1 is None else s1 + a
        s2 = b if s2 is None else s2 + b
    count = 4 * (32 // down) * (48 // down)
    j_mean = np.asarray(s1) / count
    j_cov = (np.asarray(s2) - count * np.outer(j_mean, j_mean)) / (count - 1)
    mean, cov, kept = got.content_stats(k, torch.from_numpy(x))
    assert kept is None
    np.testing.assert_allclose(mean.numpy(), j_mean, rtol=1e-4, atol=1e-4 * np.abs(j_mean).max())
    assert np.abs(cov.numpy() - j_cov).max() <= 1e-3 * np.abs(j_cov).max()
    # and both equal the whole image's statistics
    from collaborative_distillation_tpu.models import apply_encoder as jax_apply_encoder
    f_mean, f_cov = jax_feature_stats(jax_apply_encoder(jp[k]["enc"], jnp.asarray(x),
                                                        jp[k]["enc_spec"])["out"])
    assert np.abs(cov.numpy() - np.asarray(f_cov)).max() <= 1e-3 * np.abs(j_cov).max()


# ---- (e) whole cascades against the reference's ------------------------------

def test_slab_cascades_match_reference_two_stages(pyramids):
    jp, tp = pyramids
    c = _photo("in1+in1_16x.jpg", 128, 64)[None]
    s = _photo("in3+in2_16x.jpg", 64, 64)[None]
    want = np.asarray(jslab.SlabCascade(jp, stages=(2, 1), slab_rows=32, packed=False)
                      .stylize(jnp.asarray(c), jnp.asarray(s), 0.9))
    got = tslab.SlabCascade(tp, stages=(2, 1), slab_rows=32, packed=False).stylize(
        torch.from_numpy(c), torch.from_numpy(s), 0.9).numpy()
    assert got.shape == want.shape == c.shape
    assert _psnr(got, want) >= PSNR_MIN_DB
    fused = tslab.build_fused_slab_cascade(tp, stages=(2, 1), slab_rows=32, packed=False)
    assert _psnr(fused(torch.from_numpy(c), torch.from_numpy(s), 0.9).numpy(),
                 want) >= PSNR_MIN_DB


def test_slab_cascades_match_reference_five_stages(pyramids, tall):
    jp, tp = pyramids
    c, s = tall[0][None], tall[1][None]
    jfn, jparams = jslab.build_fused_slab_cascade(jp, slab_rows=288, packed=False)
    want = np.asarray(jfn(jparams, jnp.asarray(c), jnp.asarray(s), 1.0))
    per_stage = tslab.SlabCascade(tp, slab_rows=288, packed=False)
    assert len(list(per_stage._slabs(864, 5))) == 3
    got = per_stage.stylize(torch.from_numpy(c), torch.from_numpy(s), 1.0).numpy()
    fused = tslab.build_fused_slab_cascade(tp, slab_rows=288, packed=False)(
        torch.from_numpy(c), torch.from_numpy(s), 1.0).numpy()
    assert _psnr(got, want) >= PSNR_MIN_DB and _psnr(fused, want) >= PSNR_MIN_DB
    assert np.abs(got - c).mean() > 0.05  # restyled


# ---- (f) the engine's slab routing -------------------------------------------

@pytest.fixture(scope="module")
def engines(weights_root, pyramids):
    _, tp = pyramids
    je = JaxEngine(mode="16x", weights_root=weights_root, slab_rows=288, packed=False)
    return je, WCTEngine(pyramid=tp, device="cpu", slab_rows=288, packed=False)


def test_slab_engine_matches_reference_engine(weights_root, engines, tall):
    """800 rows are no slab multiple: the reference's slab engine pads them
    with mirrored rows that enter its statistics, the port's windows end at
    the image, so the port is held to the reference's plain engine."""
    _, te = engines
    c, s = tall[0][:800], tall[1]
    want = JaxEngine(mode="16x", weights_root=weights_root).stylize(c, s)
    got = te.stylize(c, s)
    assert got.shape == want.shape == c.shape
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    assert _psnr(got, want) >= PSNR_MIN_DB


def test_slab_engine_style_cache_hit_is_bit_identical(engines, tall):
    _, te = engines
    c, s = tall[0][:320], tall[1]
    first = te.stylize(c, s, style_key="blue")
    assert ("fused", "blue", (1, 64, 64, 3)) in te._style_cache
    np.testing.assert_array_equal(te.stylize(c, s, style_key="blue"), first)
    te.invalidate_style("blue")
    assert ("fused", "blue", (1, 64, 64, 3)) not in te._style_cache


def test_slab_engine_bypasses_small_images_and_refuses_batches(engines, pyramids, tall):
    _, te = engines
    _, tp = pyramids
    c, s = tall[0][:240], tall[1]   # < 2 * 144 rows: the plain path
    plain = WCTEngine(pyramid=tp, device="cpu")
    np.testing.assert_array_equal(te.stylize(c, s), plain.stylize(c, s))
    with pytest.raises(ValueError, match="per-image"):
        te.stylize(np.stack([c, c]), s)


def test_slab_engine_awkward_height_picks_an_even_slab(engines, tall):
    """A height that wastes more than a quarter slab in padding runs with the
    slab size pick_slab_rows gives, and still returns the input's shape."""
    _, te = engines
    c, s = tall[0][:600], tall[1]   # 600 pads to 864 at slab 288 (264 > 72)
    out = te.stylize(c, s)
    assert out.shape == c.shape and np.isfinite(out).all()
    assert (tslab.SlabCascade.pick_slab_rows(600, 288, 144, 16), True) not in te._fused_fns
    assert (tslab.SlabCascade.pick_slab_rows(600, 288, 144, 16), False) in te._fused_fns


@pytest.fixture(scope="module")
def mirrored():
    """The photo pair's content mirrored to 1024 rows, 256 wide, and a 128^2
    crop of the style."""
    with np.load(os.path.join(os.path.dirname(tslab.__file__), os.pardir, "data",
                              "photo_pair_512.npz")) as d:
        c, s = d["content"], d["style"]
    c = np.concatenate([c, c[::-1]])[:, :256]
    return c.astype(np.float32) / 255.0, s[:128, :128].astype(np.float32) / 255.0


@pytest.mark.parametrize("h", [704, 800, 1000])
def test_slab_engine_matches_plain_engine_at_awkward_heights(pyramids, engines, mirrored, h):
    """Heights that are no slab multiple: the last window ends at the
    image's last row and no mirrored row enters the statistics, so the slab
    engine is the plain engine's cascade up to float32 order (the
    reference's mirrored padding reads 25-33 dB here)."""
    _, tp = pyramids
    _, te = engines
    c, s = mirrored[0][:h], mirrored[1]
    want = WCTEngine(pyramid=tp, device="cpu").stylize(c, s)
    got = te.stylize(c, s)
    assert got.shape == want.shape == c.shape
    assert _psnr(got, want) >= 90.0


# ---- (g) feature cache, streamed tail ----------------------------------------

def test_feature_cache_on_equals_off(pyramids, tall):
    _, tp = pyramids
    c, s = torch.from_numpy(tall[0][None]), torch.from_numpy(tall[1][None])
    on = tslab.build_fused_slab_cascade(tp, slab_rows=288)
    off = tslab.build_fused_slab_cascade(tp, slab_rows=288, feature_cache_bytes=0)
    a, b = on(c, s, 0.8).numpy(), off(c, s, 0.8).numpy()
    assert np.abs(a - b).max() <= 1e-6


def test_streamed_tail_matches_monolithic_uint8(weights_root, pyramids, tall):
    _, tp = pyramids
    c, s = tall[0][:800], tall[1]
    mono = WCTEngine(pyramid=tp, device="cpu", slab_rows=288)
    streamed = WCTEngine(pyramid=tp, device="cpu", slab_rows=288, stream_min_pix=1)
    a = mono.stylize(c, s, as_uint8=True)
    b = streamed.stylize(c, s, as_uint8=True)
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == c.shape
    assert np.abs(a.astype(int) - b).max() <= 1
    per_stage = WCTEngine(pyramid=tp, device="cpu", slab_rows=288, fused=False)
    d = per_stage.stylize(c, s, as_uint8=True)   # its last stage streams by slab
    assert d.shape == c.shape and np.abs(a.astype(int) - d).max() <= 1


def test_stream_last_stage_bands_match_whole_stage(pyramids, tall):
    """The tail's slabs, decoded from pass 1's kept features or encoded
    anew, give the rows the whole-stage pass 2 gives, as uint8; the kept
    features are released as they are used."""
    _, tp = pyramids
    c, s = torch.from_numpy(tall[0][None]), torch.from_numpy(tall[1][None])
    head = tslab.build_fused_slab_cascade(tp, slab_rows=288, tail_stats=True)
    img, t, c_mean, s_mean, kept = head(c, s, 1.0)
    assert len(kept) == 3
    cas = head.cascade
    whole = tslab._to_u8(cas.color_decode_stage(1, img, t, c_mean, s_mean,
                                                torch.tensor(1.0))).numpy()
    encoded = cas.stream_last_stage(img, t, c_mean, s_mean, 1.0)
    from_kept = cas.stream_last_stage(img, t, c_mean, s_mean, 1.0, kept=kept)
    assert kept == [None] * 3
    assert whole.shape == encoded.shape == from_kept.shape == (1, 864, 64, 3)
    assert np.abs(encoded.astype(int) - whole).max() <= 1
    assert np.abs(from_kept.astype(int) - whole).max() <= 1
    with pytest.raises(ValueError, match="emit"):
        cas.stream_last_stage(img, t, c_mean, s_mean, 1.0, emit="rgb565")


# ---- the one-pixel cascade ---------------------------------------------------

@pytest.mark.parametrize("slab_rows", [0, 1024], ids=["plain", "slab_bypass"])
def test_one_pixel_cascade_is_nan_like_reference(weights_root, pyramids, slab_rows):
    """A 16x16 image reaches relu5_1 at 1x1, whose covariance is 0/0: the
    reference engine stylizes it to all-NaN, on its plain path and on its
    slab engine's small-image bypass; so does the port, without raising."""
    _, tp = pyramids
    rng = np.random.default_rng(0)
    c, s = rng.random((16, 16, 3), np.float32), rng.random((16, 16, 3), np.float32)
    want = JaxEngine(mode="16x", weights_root=weights_root, slab_rows=slab_rows,
                     packed=False).stylize(c, s)
    got = WCTEngine(pyramid=tp, device="cpu", slab_rows=slab_rows, packed=False).stylize(c, s)
    assert np.isnan(want).all() and np.isnan(got).all()
    mean, cov = tw.feature_stats(torch.from_numpy(c[:1, :1]))
    assert torch.isfinite(mean).all() and torch.isnan(cov).all()
