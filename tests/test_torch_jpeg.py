"""The port's JPEG endpoints and codec copy against the reference package's,
on the CPU: ``stylize_planes_jpeg``, ``stylize_jpeg``,
``supports_streamed_jpeg`` and their None contract, and
``collaborative_distillation_tpu_torch/data/native_codec.py`` (built from
``native/imgcodec.cpp`` into ``build/torch_kernels/``).

The engines run a random two-stage 16x pyramid (stages 2 and 1) on the
fused slab path at ``slab_rows=32``, as the reference's own JPEG tests do,
on a 96x64 crop of the photo pair: three windows, the streamed tail fed to
the incremental encoder band by band. The streamed bytes must equal
``stylize_planes`` + ``encode_jpeg_yuv420`` of the same input exactly; the
port's decoded output is held to the reference's at PSNR >= 40 dB.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

import jax

from collaborative_distillation_tpu.data import native_codec as jnc
from collaborative_distillation_tpu.models.specs import decoder_spec, encoder_spec
from collaborative_distillation_tpu.models.vgg import init_params
from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine

import torch

from collaborative_distillation_tpu_torch.data import native_codec as tnc
from collaborative_distillation_tpu_torch.utils import colorspace as tcs
from collaborative_distillation_tpu_torch.utils.params import pyramid_from_jax
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = (2, 1)
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


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def pyramids():
    key = jax.random.key(19)
    jp = {}
    for s in STAGES:
        key, k1, k2 = jax.random.split(key, 3)
        espec, dspec = encoder_spec("16x", s, aux=True), decoder_spec("16x", s)
        jp[s] = {"enc_spec": espec, "dec_spec": dspec,
                 "enc": init_params(espec, k1), "dec": init_params(dspec, k2)}
    tp = pyramid_from_jax({k: {**v, "enc": jax.tree.map(np.asarray, v["enc"]),
                               "dec": jax.tree.map(np.asarray, v["dec"])}
                           for k, v in jp.items()})
    return jp, tp


@pytest.fixture(scope="module")
def engines(pyramids):
    jp, tp = pyramids
    je = JaxEngine(mode="16x", pyramid=jp, stages=STAGES, slab_rows=32, fused=True,
                   packed=False, stream_min_pix=0)
    te = WCTEngine(pyramid=tp, stages=STAGES, device="cpu", slab_rows=32, stream_min_pix=0)
    return je, te


@pytest.fixture(scope="module")
def pair():
    with np.load(os.path.join(REPO, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c, s = d["content"][200:296, 100:164], d["style"][:48, :32]
    y, cbcr = tnc.rgb_to_yuv420(c)
    return c, s, y, cbcr, tnc.encode_jpeg_yuv420(y, cbcr, quality=95)


def _decoded(jpeg):
    return tcs.yuv420_to_rgb_host(*(p[None] for p in tnc.decode_jpeg_yuv420(jpeg)))[0]


# ---- the codec copy ----------------------------------------------------------------

def test_codec_copy_builds_outside_native_and_matches_reference(pair):
    c, _, y, cbcr, jpeg = pair
    assert tnc.available() and tnc.unavailable_reason() is None
    d = tnc.build_dir()
    assert d.startswith(os.path.join(REPO, "build", "torch_kernels") + os.sep)
    assert os.path.exists(os.path.join(d, "libimgcodec.so"))
    for got, want in zip(tnc.rgb_to_yuv420(c), jnc.rgb_to_yuv420(c)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tnc.yuv420_to_rgb(y, cbcr), jnc.yuv420_to_rgb(y, cbcr))
    assert jpeg == jnc.encode_jpeg_yuv420(y, cbcr, quality=95)
    for got, want in zip(tnc.decode_jpeg_yuv420(jpeg), jnc.decode_jpeg_yuv420(jpeg)):
        np.testing.assert_array_equal(got, want)
    # the incremental reader and writer: bands equal the whole planes
    rd = tnc.jpeg_yuv420_reader(jpeg)
    assert (rd.w, rd.h) == (64, 96)
    parts = [rd.read(32) for _ in range(3)]
    assert rd.done and rd.read(32) is None
    wy, wc = tnc.decode_jpeg_yuv420(jpeg)
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), wy)
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), wc)
    wr = tnc.jpeg_yuv420_writer(64, 96, 95)
    assert wr.write(y[:48], cbcr[:24]) and wr.write(y[48:], cbcr[24:])
    assert wr.finish() == jpeg
    wr = tnc.jpeg_yuv420_writer(64, 96, 95)
    assert not wr.write(y[:10], cbcr[:5]) and wr.finish() is None   # misuse kills it
    assert tnc.jpeg_yuv420_writer(63, 96) is None
    assert tnc.decode_jpeg_yuv420(jpeg, max_pixels=100) is None
    assert tnc.jpeg_yuv420_reader(jpeg, max_pixels=100) is None


def test_unavailable_codec_is_reported_with_the_compilers_reason(engines, pair, monkeypatch,
                                                                 tmp_path):
    """A codec that cannot build is reported with the compiler's output and
    papered over by nothing: the converters take numpy, the JPEG endpoints
    return None (the reference's contract for a machine without the codec)
    and ``supports_streamed_jpeg`` does not change."""
    _, te = engines
    c, s, y, cbcr, jpeg = pair
    monkeypatch.setattr(tnc, "_lib", None)
    monkeypatch.setattr(tnc, "_reason", None)
    monkeypatch.setattr(tnc, "_CMD", ["g++", "--no-such-option"])
    monkeypatch.setattr(tnc, "build_dir", lambda: str(tmp_path))
    assert not tnc.available()
    reason = tnc.unavailable_reason()
    assert "g++ exited" in reason and "no-such-option" in reason
    assert tnc.rgb_to_yuv420(c) is None and tnc.jpeg_yuv420_reader(jpeg) is None
    assert tnc.encode_jpeg_yuv420(y, cbcr) is None and tnc.jpeg_yuv420_writer(64, 96) is None
    assert te.supports_streamed_jpeg()
    assert te.stylize_jpeg(jpeg, s) is None and te.stylize_planes_jpeg(y, cbcr, s) is None
    ny, nc = tcs.rgb_to_yuv420_host(c[None])   # numpy, within a level of the codec's
    assert np.abs(ny[0].astype(int) - y).max() <= 1 and np.abs(nc[0].astype(int) - cbcr).max() <= 1
    assert os.listdir(tmp_path) == []


# ---- the endpoints -----------------------------------------------------------------

def test_stylize_planes_jpeg_bytes_equal_planes_plus_encode(engines, pair):
    je, te = engines
    _, s, y, cbcr, _ = pair
    body = te.stylize_planes_jpeg(y, cbcr, s, alpha=0.8, style_key="j")
    assert body is not None and body[:2] == b"\xff\xd8"
    yo, co = te.stylize_planes(y, cbcr, s, alpha=0.8, style_key="j")
    assert body == tnc.encode_jpeg_yuv420(yo, co, quality=95)
    want = je.stylize_planes_jpeg(y, cbcr, s, alpha=0.8, style_key="j")
    assert _psnr(_decoded(body), _decoded(want)) >= PSNR_MIN_DB


def test_stylize_jpeg_bytes_equal_the_whole_path(engines, pair):
    je, te = engines
    _, s, _, _, jpeg = pair
    body = te.stylize_jpeg(jpeg, s, alpha=0.8, style_key="fj", quality=90)
    assert body is not None and body[:2] == b"\xff\xd8"
    dy, dc = tnc.decode_jpeg_yuv420(jpeg)
    yo, co = te.stylize_planes(dy, dc, s, alpha=0.8, style_key="fj")
    assert body == tnc.encode_jpeg_yuv420(yo, co, quality=90)
    want = je.stylize_jpeg(jpeg, s, alpha=0.8, style_key="fj", quality=90)
    assert _psnr(_decoded(body), _decoded(want)) >= PSNR_MIN_DB


def _failing_reader(real):
    """A reader factory whose readers fail at their second band."""
    def make(data, **kw):
        r = real(data, **kw)
        if r is not None:
            read, calls = r.read, []
            r.read = lambda rows: None if calls.append(rows) or len(calls) == 2 else read(rows)
        return r
    return make


@pytest.mark.parametrize("case", ["junk", "truncated_header", "subsampling_444",
                                  "corrupt_mid_stream", "below_stream_min_pix",
                                  "no_slab_path", "per_stage_slab_path", "row_shards"])
def test_endpoints_return_none_like_the_reference(pyramids, engines, pair, monkeypatch, case):
    """Each case where the reference's JPEG endpoints return None (the
    caller then takes the whole path) returns None on the port too, and
    ``supports_streamed_jpeg`` agrees with the reference's."""
    jp, tp = pyramids
    je, te = engines
    c, s, y, cbcr, jpeg = pair
    data = jpeg
    if case == "junk":
        data = b"junk"
    elif case == "truncated_header":
        data = jpeg[:120]
    elif case == "subsampling_444":
        buf = io.BytesIO()
        Image.fromarray(c).save(buf, format="JPEG", quality=95, subsampling=0)
        data = buf.getvalue()
    elif case == "corrupt_mid_stream":
        monkeypatch.setattr(tnc, "jpeg_yuv420_reader", _failing_reader(tnc.jpeg_yuv420_reader))
        monkeypatch.setattr(jnc, "jpeg_yuv420_reader", _failing_reader(jnc.jpeg_yuv420_reader))
    else:
        kw, jkw = {}, {}
        if case == "below_stream_min_pix":
            kw = jkw = dict(slab_rows=32, stream_min_pix=96 * 64 + 1)
        elif case == "per_stage_slab_path":
            kw = jkw = dict(slab_rows=32, fused=False)
        elif case == "row_shards":
            kw = dict(slab_rows=32, space=2, devices=["cpu"] * 2)
            jkw = dict(slab_rows=32, space=2)
        je = JaxEngine(mode="16x", pyramid=jp, stages=STAGES, packed=False, **jkw)
        te = WCTEngine(pyramid=tp, stages=STAGES, device="cpu", **kw)
    assert te.supports_streamed_jpeg() == je.supports_streamed_jpeg()
    assert je.stylize_jpeg(data, s) is None
    assert te.stylize_jpeg(data, s) is None
    if case in ("below_stream_min_pix", "no_slab_path", "per_stage_slab_path", "row_shards"):
        assert je.stylize_planes_jpeg(y, cbcr, s) is None
        assert te.stylize_planes_jpeg(y, cbcr, s) is None
