"""JPEG by the device's codec, on the CPU (there is no card here): the seam
(``data/jpeg.py``) takes libjpeg for ``"cpu"`` and nvJPEG for a CUDA
device and never the other; a CUDA device whose nvJPEG cannot load raises
``CodecUnavailable`` with nvJPEG's reason (and the server answers 415 with
it) without reaching libjpeg; the nvJPEG shim's build line, build directory
and ctypes signatures, checked without building it; the fixture the card's
tests hold nvJPEG against equals a fresh decode by the reference package's
libjpeg binding; the engine's planes endpoint on tensors. The card's own
checks are in ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 6a.
"""

import io
import json
import os
import re
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
from PIL import Image

from collaborative_distillation_tpu.data import native_codec as jnc
from collaborative_distillation_tpu_torch.cli import serve
from collaborative_distillation_tpu_torch.data import jpeg
from collaborative_distillation_tpu_torch.data import native_codec as tnc
from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
from collaborative_distillation_tpu_torch.data.png import encode_png
from collaborative_distillation_tpu_torch.utils import image as timage
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "collaborative_distillation_tpu_torch", "data")
NO_NVJPEG = "nvJPEG unavailable: no libnvjpeg in this toolkit"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process (several run at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture():
    if not jnc.available():
        pytest.skip(f"the reference codec did not build: {jnc.unavailable_reason()}")
    with np.load(os.path.join(DATA, "jpeg_fixture.npz")) as d:
        return {k: d[k] for k in d.files}


@pytest.fixture()
def no_nvjpeg(monkeypatch):
    """nvJPEG cannot load, and libjpeg may not be reached at all."""
    monkeypatch.setattr(nj, "_lib", None)
    monkeypatch.setattr(nj, "_reason", NO_NVJPEG)

    def refuse():
        raise AssertionError("a CUDA device reached libjpeg")
    monkeypatch.setattr(tnc, "_load", refuse)


# ---- the fixture ------------------------------------------------------------------------

def test_fixture_equals_a_fresh_libjpeg_decode(fixture):
    with open(os.path.join(REPO, "docs", "examples", "in1+in1_16x.jpg"), "rb") as f:
        assert fixture["in1_jpeg"].tobytes() == f.read()
    for name in ("in1", "c444", "prog", "odd", "grey"):
        np.testing.assert_array_equal(jnc.decode_jpeg(fixture[f"{name}_jpeg"].tobytes()),
                                      fixture[f"{name}_rgb"])
    y, cbcr = jnc.decode_jpeg_yuv420(fixture["in1_jpeg"].tobytes())
    np.testing.assert_array_equal(y, fixture["in1_y"])
    np.testing.assert_array_equal(cbcr, fixture["in1_cbcr"])
    with np.load(os.path.join(DATA, "photo_pair_512.npz")) as d:
        y, cbcr = jnc.rgb_to_yuv420(d["content"])
    np.testing.assert_array_equal(y, fixture["content_y"])
    np.testing.assert_array_equal(cbcr, fixture["content_cbcr"])
    assert jnc.encode_jpeg_yuv420(y, cbcr, quality=95) == fixture["content_q95"].tobytes()
    # the sampling each file stands for
    for name, planes in (("in1", True), ("c444", False), ("prog", False), ("odd", False),
                         ("grey", False)):
        assert (jnc.decode_jpeg_yuv420(fixture[f"{name}_jpeg"].tobytes()) is not None) == planes


# ---- the seam -----------------------------------------------------------------------------

def test_the_cpu_takes_libjpeg_and_never_nvjpeg(fixture, monkeypatch):
    def refuse():
        raise AssertionError("the CPU reached nvJPEG")
    monkeypatch.setattr(nj, "_load", refuse)
    assert jpeg.codec("cpu") is tnc and jpeg.codec_name("cpu") == "libjpeg"
    assert jpeg.available("cpu") and jpeg.unavailable_reason("cpu") is None
    data = fixture["in1_jpeg"].tobytes()
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, "cpu"), fixture["in1_rgb"])
    y, cbcr = jpeg.decode_jpeg_yuv420(data, "cpu")
    np.testing.assert_array_equal(y, fixture["in1_y"])
    assert jpeg.decode_jpeg_yuv420(fixture["c444_jpeg"].tobytes(), "cpu") is None
    assert jpeg.decode_jpeg(data, "cpu", max_pixels=100) is None
    rgb = fixture["odd_rgb"]
    assert jpeg.encode_jpeg(rgb, "cpu", quality=90) == tnc.encode_jpeg(rgb, quality=90)
    assert jpeg.encode_jpeg_yuv420(y, cbcr, "cpu") == tnc.encode_jpeg_yuv420(y, cbcr)
    assert jpeg.encode_jpeg_yuv420(torch.from_numpy(y), torch.from_numpy(cbcr), "cpu") == \
        tnc.encode_jpeg_yuv420(y, cbcr)
    np.testing.assert_array_equal(timage.decode_image(data, device="cpu"), fixture["in1_rgb"])


def test_a_cuda_device_takes_nvjpeg_and_never_libjpeg(fixture, no_nvjpeg, tmp_path):
    data = fixture["in1_jpeg"].tobytes()
    for dev in ("cuda", "cuda:0", None):   # None: the card, every entry point's default
        assert jpeg.codec(dev) is nj and jpeg.codec_name(dev) == "nvjpeg"
        assert not jpeg.available(dev) and jpeg.unavailable_reason(dev) == NO_NVJPEG
        for call in (lambda: jpeg.decode_jpeg(data, dev),
                     lambda: jpeg.decode_jpeg_yuv420(data, dev),
                     lambda: jpeg.encode_jpeg(fixture["in1_rgb"], dev),
                     lambda: jpeg.encode_jpeg_yuv420(fixture["in1_y"], fixture["in1_cbcr"], dev)):
            with pytest.raises(jpeg.CodecUnavailable, match=NO_NVJPEG):
                call()
    (tmp_path / "a.jpg").write_bytes(data)
    with pytest.raises(timage.CodecUnavailable, match="a.jpg: " + NO_NVJPEG):
        timage.read_image(str(tmp_path / "a.jpg"))
    with pytest.raises(timage.CodecUnavailable, match="b.jpg: " + NO_NVJPEG):
        timage.save_image(fixture["in1_rgb"], str(tmp_path / "b.jpg"), device="cuda")
    path, why = timage.jpeg_or_png(str(tmp_path / "b.jpg"), device="cuda")
    assert path == str(tmp_path / "b.png") and why == NO_NVJPEG
    # PNG needs no codec on either device
    timage.save_image(fixture["in1_rgb"], path, device="cuda")
    np.testing.assert_array_equal(timage.read_image(path), fixture["in1_rgb"])
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        jpeg.codec("meta")


def test_nvjpeg_without_a_card_builds_nothing_and_says_why(fixture, monkeypatch):
    monkeypatch.setattr(nj, "_lib", None)
    monkeypatch.setattr(nj, "_reason", None)
    monkeypatch.setattr(nj, "last_build", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not nj.available()
    assert nj.unavailable_reason() == "nvJPEG unavailable: CUDA is not available"
    assert nj.last_build == {}   # no nvcc was run
    data = fixture["in1_jpeg"].tobytes()
    assert nj.decode_jpeg(data) is None and nj.decode_jpeg_yuv420(data) is None
    assert nj.memory() is None and nj.version() is None
    with pytest.raises(ValueError, match="CUDA device"):
        nj.decode_jpeg(data, "cpu")


class _CardEngine:
    """What ``build_app`` reads of an engine on the card, with no cascade:
    a request that reaches the cascade fails the test."""

    device = torch.device("cuda")
    mode, method, stages = "16x", "eigh", (5, 4, 3, 2, 1)

    def __init__(self, transport):
        self.transport = transport

    def supports_streamed_jpeg(self):
        return False

    def invalidate_style(self, key):
        pass

    def stylize(self, *a, **kw):
        raise AssertionError("the cascade ran")


def _post(url, body):
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST")) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("transport", ["auto", "yuv420"])
def test_server_on_a_card_without_nvjpeg_answers_415_with_its_reason(fixture, no_nvjpeg,
                                                                      transport):
    logs = []
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.build_app(_CardEngine(transport),
                                                                logs.append))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz") as r:
            health = json.loads(r.read())
        assert health["device"] == "cuda" and health["jpeg_codec"] == "nvjpeg"
        assert health["codec"] == NO_NVJPEG
        data = fixture["in1_jpeg"].tobytes()
        assert _post(url + "/style/s", encode_png(fixture["in1_rgb"][:32, :32]))[0] == 200
        for path in ("/stylize?style=s", "/style/j"):
            code, body = _post(url + path, data)
            assert code == 415 and json.loads(body) == {"error": NO_NVJPEG,
                                                        "accepts": ["image/png"]}
        assert any("request refused" in line and NO_NVJPEG in line for line in logs)
    finally:
        srv.shutdown()
        srv.server_close()


def test_encode_response_falls_back_to_png_where_the_codec_cannot_load(fixture, no_nvjpeg):
    rgb = fixture["odd_rgb"]
    body, ctype = serve.encode_response(rgb, "cuda")
    assert ctype == "image/png" and body == encode_png(rgb)
    assert serve.codec_state("cuda") == NO_NVJPEG


def test_the_cpu_server_answers_jpeg_through_libjpeg(fixture):
    rgb = fixture["odd_rgb"]
    body, ctype = serve.encode_response(rgb, "cpu")
    assert ctype == "image/jpeg" and body == tnc.encode_jpeg(rgb, quality=95)
    assert serve.codec_state("cpu") == "available"


# ---- the shim, unbuilt --------------------------------------------------------------------

def test_build_line_and_directory_without_building(monkeypatch, tmp_path):
    home = "/opt/toolkit"
    cmd = nj.build_command(home, "/x/lib.so")
    assert cmd == [f"{home}/bin/nvcc", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                   nj._SRC, "-o", "/x/lib.so", f"-I{home}/include", f"-L{home}/lib64",
                   "-lnvjpeg", "-Xlinker", f"-rpath={home}/lib64"]
    d = nj.build_dir()
    assert re.fullmatch(re.escape(os.path.join(REPO, "build", "torch_kernels", "nvjpeg-"))
                        + "[0-9a-f]{16}", d) and d == nj.build_dir()
    src = tmp_path / "nvjpeg_codec.cpp"
    src.write_bytes(open(nj._SRC, "rb").read() + b"\n")
    monkeypatch.setattr(nj, "_SRC", str(src))
    assert nj.build_dir() != d   # keyed by the source
    monkeypatch.setenv("CUDA_HOME", home)
    assert nj.cuda_home() == home


def test_ctypes_signatures_match_the_c_entry_points():
    with open(nj._SRC) as f:
        text = f.read()
    found = {n: len([a for a in args.split(",") if a.strip()])
             for n, args in re.findall(r"^int (cd_nvjpeg_\w+)\(([^)]*)\)", text, re.M)}
    assert found == {n: len(a) for n, a in nj._SIGNATURES.items()}


# ---- the engine's planes endpoint on tensors ----------------------------------------------

def test_stylize_planes_takes_tensors_and_gives_device_planes(fixture):
    eng = WCTEngine(mode="16x", device="cpu")
    y, cbcr = fixture["in1_y"][:96, :64], fixture["in1_cbcr"][:48, :32]
    style = fixture["grey_rgb"][:48, :48]
    want = eng.stylize_planes(y, cbcr, style)
    got = eng.stylize_planes(torch.from_numpy(y.copy()), torch.from_numpy(cbcr.copy()), style,
                             on_device=True)
    assert all(isinstance(g, torch.Tensor) and g.device.type == "cpu" for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # the endpoints' None contract on an engine that has no JPEG tail
    assert eng.stylize_planes_jpeg(y, cbcr, style) is None
    assert eng.stylize_jpeg(fixture["in1_jpeg"].tobytes(), style) is None


def test_pil_reads_what_the_cpu_seam_writes(fixture):
    data = jpeg.encode_jpeg(fixture["c444_rgb"], "cpu", quality=95)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float64)
    mse = np.mean((pil - fixture["c444_rgb"]) ** 2)
    assert 10 * np.log10(255.0 ** 2 / mse) >= 35.0
