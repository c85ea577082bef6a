"""The port's host boundary against the reference package's, on the CPU: the
YCbCr 4:2:0 converters (``utils/colorspace.py``), the engine's transport
legs (``transport="auto"|"rgb"|"yuv420"``, the banded plane upload),
``stylize_planes``, the streamed tail's plane emits, ``stylize(timed=True)``
and ``stylize_pairs``, on the shipped 16x weights and crops of the photo
pair (``collaborative_distillation_tpu_torch/data/photo_pair_512.npz``).

Tolerances: the host converters are the same numpy formula (exact) or the
same native loop (exact), and the native loop is within one level of the
numpy formula; the device converters are float32 on both sides, summed in
other orders, so within one level and equal on >= 99.9 % of values; whole
cascades are held to PSNR >= 40 dB (tests/test_torch_engine.py), and a
streamed result to the monolithic one exactly.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from collaborative_distillation_tpu.data import native_codec as jnc
from collaborative_distillation_tpu.utils import colorspace as jcs
from collaborative_distillation_tpu.wct import engine as jengine
from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine

import torch

from collaborative_distillation_tpu_torch.data import native_codec as tnc
from collaborative_distillation_tpu_torch.utils import colorspace as tcs
from collaborative_distillation_tpu_torch.utils import transfer
from collaborative_distillation_tpu_torch.utils.params import pyramid_from_jax
from collaborative_distillation_tpu_torch.wct import engine as tengine
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

PSNR_MIN_DB = 40.0
PAIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "collaborative_distillation_tpu_torch", "data", "photo_pair_512.npz")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr(a, b, peak=1.0):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(peak ** 2 / mse)


@pytest.fixture(scope="module")
def photo():
    with np.load(PAIR) as d:
        return d["content"], d["style"]


@pytest.fixture(scope="module")
def engines(weights_root):
    je = JaxEngine(mode="16x", weights_root=weights_root)
    tp = pyramid_from_jax({k: {**v, "enc": jax.tree.map(np.asarray, v["enc"]),
                               "dec": jax.tree.map(np.asarray, v["dec"])}
                           for k, v in je.pyramid.items()})
    return je, WCTEngine(pyramid=tp, device="cpu"), tp


def _no_native(monkeypatch):
    for nc in (tnc, jnc):
        monkeypatch.setattr(nc, "rgb_to_yuv420", lambda *_: None)
        monkeypatch.setattr(nc, "yuv420_to_rgb", lambda *_: None)


# ---- the converters ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 8, 8), (2, 32, 48), (1, 62, 90)], ids=str)
def test_host_converters_match_reference(shape, monkeypatch):
    rng = np.random.default_rng(1)
    x = (rng.random((*shape, 3)) * 255).astype(np.uint8)
    assert tnc.available() and jnc.available()
    y, c = tcs.rgb_to_yuv420_host(x)
    jy, jc = jcs.rgb_to_yuv420_host(x)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(c, jc)
    back = tcs.yuv420_to_rgb_host(y, c)
    np.testing.assert_array_equal(back, jcs.yuv420_to_rgb_host(y, c))
    # the numpy fallback: the reference's formula, exactly
    _no_native(monkeypatch)
    ny, nc = tcs.rgb_to_yuv420_host(x)
    jny, jnc_ = jcs.rgb_to_yuv420_host(x)
    np.testing.assert_array_equal(ny, jny)
    np.testing.assert_array_equal(nc, jnc_)
    nback = tcs.yuv420_to_rgb_host(y, c)
    np.testing.assert_array_equal(nback, jcs.yuv420_to_rgb_host(y, c))
    # the native loop within one level of the numpy formula
    assert np.abs(y.astype(int) - ny).max() <= 1 and np.abs(c.astype(int) - nc).max() <= 1
    assert np.abs(back.astype(int) - nback).max() <= 1
    with pytest.raises(ValueError, match="even"):
        tcs.rgb_to_yuv420_host(x[:, :-1])


def test_device_converters_match_reference():
    rng = np.random.default_rng(2)
    y = (rng.random((2, 48, 64)) * 255).astype(np.uint8)
    c = (rng.random((2, 24, 32, 2)) * 255).astype(np.uint8)
    got = tcs.yuv420_to_rgbf_device(torch.from_numpy(y), torch.from_numpy(c)).numpy()
    want = np.asarray(jcs.yuv420_to_rgbf_device(jnp.asarray(y), jnp.asarray(c)))
    assert got.shape == want.shape == (2, 48, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    img = rng.random((2, 48, 64, 3), np.float32) * 1.2 - 0.1   # clipped on both sides
    for g, w in zip(tcs.rgbf_to_yuv420_device(torch.from_numpy(img)),
                    jcs.rgbf_to_yuv420_device(jnp.asarray(img))):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype == np.uint8 and g.shape == w.shape
        assert np.abs(g.astype(int) - w).max() <= 1
        assert (g == w).mean() >= 0.999


def test_push_and_fetch_on_the_cpu_are_views():
    a = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    t = transfer.push(a, "cpu")
    assert t.dtype == torch.uint8 and t.shape == (2, 3, 4) and np.shares_memory(t.numpy(), a)
    assert np.shares_memory(transfer.fetch(t), a)


# ---- the transport legs ----------------------------------------------------------

@pytest.mark.parametrize("kind,shape,transport,auto_pix,want", [
    ("u8", (64, 96), "auto", 4096, "yuv420"),
    ("u8", (64, 96), "auto", None, "rgb"),
    ("u8", (64, 96), "auto", 6145, "rgb"),
    ("f32", (64, 96), "auto", 16, "rgb"),
    ("f32", (64, 96), "yuv420", None, "rgb"),      # float input stays lossless
    ("u8", (33, 47), "yuv420", None, "yuv420"),    # odd sizes: edge-padded to even
    ("u8", (33, 47), "rgb", 16, "rgb"),
], ids=str)
def test_transport_resolution_matches_reference(engines, photo, monkeypatch, kind, shape,
                                                transport, auto_pix, want):
    je, te, _ = engines
    c = photo[0][:shape[0], :shape[1]]
    c = c if kind == "u8" else c.astype(np.float32) / 255.0
    s = photo[1][:32, :32]
    monkeypatch.setattr(tengine, "_YUV_AUTO_PIX", auto_pix)
    monkeypatch.setattr(jengine, "_YUV_AUTO_PIX", 10 ** 12 if auto_pix is None else auto_pix)
    img, sty, squeeze, orig, got = te._to_device(c, s, transport)
    j_img, j_sty, j_squeeze, j_orig, j_got = je._to_device(c, s, transport)
    assert got == j_got == want and squeeze == j_squeeze and orig == j_orig == shape
    assert tuple(img.shape) == j_img.shape and tuple(sty.shape) == j_sty.shape
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sty.numpy(), np.asarray(j_sty), atol=1e-6, rtol=0)


def test_float_input_ignores_yuv420_and_stays_lossless(engines, photo):
    _, te, _ = engines
    c, s = photo[0][:48, :64].astype(np.float32) / 255.0, photo[1][:32, :32]
    np.testing.assert_array_equal(te.stylize(c, s, transport="yuv420"),
                                  te.stylize(c, s, transport="rgb"))


@pytest.mark.parametrize("bands", [None, 3, 5])
def test_banded_upload_equals_whole(engines, photo, bands):
    """1040 rows: four bands by default (H >= 1024); even band heights keep
    the chroma boxes band-local, so the planes equal the whole image's and
    the reference's."""
    je, te, _ = engines
    c = np.concatenate([photo[0], photo[0][::-1], photo[0][:16]])[None, :, :64]
    assert c.shape == (1, 1040, 64, 3)
    y, cb = te._upload_yuv420(c, bands=bands)
    y1, cb1 = te._upload_yuv420(c, bands=1)
    jy, jcb = je._upload_yuv420(c)
    for got, whole, ref in ((y, y1, jy), (cb, cb1, jcb)):
        np.testing.assert_array_equal(got.numpy(), whole.numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_plane_bands_upload_in_order_with_backpressure(engines, monkeypatch):
    """Band i is taken only after band i-2 was uploaded: at most three bands
    wait on the host."""
    _, te, _ = engines
    taken, sent = [], []
    real = tengine.push

    def spy(a, device, **kw):
        sent.append(int(a.flat[0]))
        return real(a, device, **kw)

    def bands():
        for i in range(7):
            taken.append(len(set(sent)))
            yield np.full((1, 2, 4), i, np.uint8), np.full((1, 1, 2, 2), i, np.uint8)

    monkeypatch.setattr(tengine, "push", spy)
    y, c = te._upload_plane_bands(bands())
    assert y[0, ::2, 0].tolist() == list(range(7)) and c.shape == (1, 7, 2, 2)
    assert all(n >= i - 2 for i, n in enumerate(taken))


def test_stylize_planes_and_yuv420_transport_match_reference(engines, photo):
    je, te, _ = engines
    c, s = photo[0][:64, :96], photo[1][32:96, 32:96]
    y, cb = tnc.rgb_to_yuv420(c)
    ty, tc = te.stylize_planes(y, cb, s, alpha=0.9)
    jy, jc = je.stylize_planes(y, cb, s, alpha=0.9)
    assert ty.shape == jy.shape == (64, 96) and tc.shape == jc.shape == (32, 48, 2)
    assert ty.dtype == tc.dtype == np.uint8
    assert _psnr(ty, jy, 255.0) >= PSNR_MIN_DB and _psnr(tc, jc, 255.0) >= PSNR_MIN_DB
    got = te.stylize(c, s, as_uint8=True, transport="yuv420")
    want = je.stylize(c, s, as_uint8=True, transport="yuv420")
    assert got.shape == want.shape == c.shape
    assert _psnr(got, want, 255.0) >= PSNR_MIN_DB
    odd = te.stylize(c[:63, :95], s, as_uint8=True, transport="yuv420")
    assert odd.shape == (63, 95, 3)
    with pytest.raises(ValueError, match="even"):
        te.stylize_planes(y[:63], cb, s)


def test_timed_stylize_records_the_legs(engines, photo):
    _, te, _ = engines
    c, s = photo[0][:48, :64], photo[1][:32, :32]
    out = te.stylize(c, s, as_uint8=True, timed=True)
    t = te.last_timings
    assert set(t) == {"upload_s", "compute_s", "readback_s", "total_s"}
    assert t["compute_s"] > 0 and t["total_s"] >= t["compute_s"]
    np.testing.assert_array_equal(out, te.stylize(c, s, as_uint8=True))


# ---- the streamed tail's plane emits ---------------------------------------------

def test_streamed_emits_equal_monolithic(engines, photo):
    """A 640x64 image on the fused slab path (slab_rows=288: two windows,
    the last shifted up to end at the image): the streamed last stage's
    planes, its 4:2:0 RGB and its bands fed to ``on_band`` equal the
    monolithic cascade's."""
    _, _, tp = engines
    c = np.concatenate([photo[0], photo[0][::-1]])[:640, :64]
    s = photo[1][:64, :64]
    mono = WCTEngine(pyramid=tp, device="cpu", slab_rows=288)
    stream = WCTEngine(pyramid=tp, device="cpu", slab_rows=288, stream_min_pix=1)
    y, cb = tnc.rgb_to_yuv420(c)
    for got, want in zip(stream.stylize_planes(y, cb, s), mono.stylize_planes(y, cb, s)):
        np.testing.assert_array_equal(got, want)
    for transport in ("yuv420", "rgb"):
        np.testing.assert_array_equal(stream.stylize(c, s, as_uint8=True, transport=transport),
                                      mono.stylize(c, s, as_uint8=True, transport=transport))
    img, sty = stream._prep(c), stream._prep(s)
    head = stream._fused_fn(288, True)
    h_img, t, c_mean, s_mean, _ = head(img, stream._fused_style_stats(sty), 1.0)
    cas = head.cascade
    whole = cas.stream_last_stage(h_img, t, c_mean, s_mean, 1.0, emit="planes")
    bands = []
    assert cas.stream_last_stage(h_img, t, c_mean, s_mean, 1.0, emit="planes",
                                 on_band=bands.append) is None
    assert [b[0].shape[1] for b in bands] == [288, 288, 64]
    np.testing.assert_array_equal(np.concatenate([b[0] for b in bands], 1), whole[0])
    np.testing.assert_array_equal(np.concatenate([b[1] for b in bands], 1), whole[1])
    rgb = cas.stream_last_stage(h_img, t, c_mean, s_mean, 1.0, emit="yuv420")
    np.testing.assert_array_equal(rgb, tcs.yuv420_to_rgb_host(*whole))


# ---- many pairs --------------------------------------------------------------------

def test_stylize_pairs_equals_serial_and_keys_are_strict(engines, photo):
    je, te, _ = engines
    c, s = photo
    pairs = [(c[:64, :96], s[:48, :48]), (c[100:148, :64], s[:48, :48]),
             (c[:40, :40].astype(np.float32) / 255.0, s[64:96, 64:96])]
    keys = ["a", "a", "b"]
    got = list(te.stylize_pairs(iter(pairs), 0.8, style_keys=keys))
    want = [te.stylize(a, b, 0.8, style_key=k, as_uint8=True) for (a, b), k in zip(pairs, keys)]
    ref = list(je.stylize_pairs(pairs, 0.8, style_keys=keys))
    assert len(got) == len(want) == len(ref) == 3
    for g, w, r in zip(got, want, ref):
        assert g.dtype == np.uint8 and g.shape == w.shape == r.shape
        np.testing.assert_array_equal(g, w)
        assert _psnr(g, r, 255.0) >= PSNR_MIN_DB
    floats = list(te.stylize_pairs(pairs[:2], as_uint8=False))
    np.testing.assert_array_equal(floats[1], te.stylize(*pairs[1]))
    with pytest.raises(ValueError):
        list(te.stylize_pairs(pairs, style_keys=["a"]))
    assert list(te.stylize_pairs([])) == []
