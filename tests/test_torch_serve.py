"""The port's stylization server (``collaborative_distillation_tpu_torch/cli/serve.py``)
on the CPU: the reference server's flows (health, unknown styles, garbage
bodies, the warming flag, LRU eviction, re-registration races, metrics,
blends, warm shapes, the streamed JPEG path, the transport gate), the
port's own rules (PNG bodies and responses, a 415 for a JPEG where the
native codec is not built, responses equal to the engine's direct call)
and the port's response against the reference server's on the same toy
pyramid and PNG request (PSNR >= 40 dB on the decoded pixels).

The engines run one random stage-1 ``16x`` pyramid, as the reference's
server tests do.
"""

import io
import json
import os
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

import jax

from collaborative_distillation_tpu.cli.serve import build_app as jax_build_app
from collaborative_distillation_tpu.models import decoder_spec, encoder_spec, init_params
from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine

import torch

from collaborative_distillation_tpu_torch.cli import serve
from collaborative_distillation_tpu_torch.data import native_codec as tnc
from collaborative_distillation_tpu_torch.data.png import decode_png, encode_png
from collaborative_distillation_tpu_torch.utils.params import pyramid_from_jax
from collaborative_distillation_tpu_torch.wct import engine as tengine
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _jax_pyramid(seed=0):
    espec, dspec = encoder_spec("16x", 1, aux=True), decoder_spec("16x", 1)
    return {1: {"enc_spec": espec, "dec_spec": dspec,
                "enc": init_params(espec, jax.random.key(seed)),
                "dec": init_params(dspec, jax.random.key(seed + 1))}}


def _port_pyramid(jp):
    return pyramid_from_jax({k: {**v, "enc": jax.tree.map(np.asarray, v["enc"]),
                                 "dec": jax.tree.map(np.asarray, v["dec"])}
                             for k, v in jp.items()})


def _toy_engine(**kw):
    return WCTEngine(mode="toy", stages=(1,), pyramid=_port_pyramid(_jax_pyramid()),
                     device="cpu", **kw)


def _start(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def engine():
    return _toy_engine()


@pytest.fixture(scope="module")
def server(engine):
    srv, url = _start(serve.build_app(engine, lambda m: None))
    yield url
    srv.shutdown()


def _png(arr):
    return encode_png(arr)


def _jpeg(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, resp.read(), resp.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _get(url):
    with urllib.request.urlopen(url) as resp:
        return json.loads(resp.read())


def _decode(body, ctype):
    if ctype == "image/png":
        return decode_png(body)
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


def _u8(rng, h, w):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


def _wait_for(logs, text, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline and not any(text in m for m in logs):
        time.sleep(0.05)
    return any(text in m for m in logs)


def test_health_and_flow(server, rng):
    health = _get(server + "/healthz")
    assert health["ok"] and health["stages"] == [1]
    assert health["device"] == "cpu" and health["codec"] == "available"
    code, body, _ = _post(server + "/style/vangogh", _png(_u8(rng, 64, 64)))
    assert code == 200 and json.loads(body)["registered"] == "vangogh"
    content = _u8(rng, 48, 80)
    req = urllib.request.Request(server + "/stylize?style=vangogh&alpha=0.7",
                                 data=_png(content), method="POST")
    with urllib.request.urlopen(req) as resp:
        assert resp.status == 200 and resp.headers["Content-Type"] == "image/jpeg"
        legs = dict(p.strip().split(";dur=") for p in resp.headers["Server-Timing"].split(","))
        out = _decode(resp.read(), "image/jpeg")
    assert out.shape == content.shape
    assert set(legs) == {"decode", "cascade", "encode"} and all(float(v) >= 0 for v in
                                                                  legs.values())


def test_unknown_style_is_400(server, rng):
    code, body, _ = _post(server + "/stylize?style=nope", _png(_u8(rng, 32, 32)))
    assert code == 400 and "unknown style" in json.loads(body)["error"]


def test_garbage_body_is_500_not_crash(server, rng):
    _post(server + "/style/g500", _png(_u8(rng, 16, 16)))
    code, body, _ = _post(server + "/stylize?style=g500", b"not an image")
    assert code == 500 and "neither a PNG nor a JPEG" in json.loads(body)["error"]
    assert _get(server + "/healthz")["ok"]


def test_register_returns_immediately_with_warming_flag(server, rng):
    code, body, _ = _post(server + "/style/asyncwarm", _png(_u8(rng, 24, 24)))
    reply = json.loads(body)
    assert code == 200 and reply["registered"] == "asyncwarm" and reply["warming"] is True
    # a stylize racing the warm-up still succeeds: it queues on the engine lock
    code, _, ctype = _post(server + "/stylize?style=asyncwarm", _png(_u8(rng, 32, 32)))
    assert code == 200 and ctype == "image/jpeg"


def test_style_registry_lru_eviction(engine, rng):
    logs = []
    srv, url = _start(serve.build_app(engine, logs.append, max_styles=2))
    try:
        for name in ("a", "b", "c"):   # capacity 2: 'a' evicted
            assert _post(url + f"/style/{name}", _png(_u8(rng, 16, 16)))[0] == 200
        assert _get(url + "/styles")["styles"] == ["b", "c"]
        code, body, _ = _post(url + "/stylize?style=a", _png(_u8(rng, 32, 32)))
        assert code == 400 and b"unknown style" in body
        assert any("evicted 'a'" in m for m in logs)
    finally:
        srv.shutdown()


def test_concurrent_reregistration_cannot_poison_stats(server, rng):
    """Re-registrations of one name with different images race stylize
    requests; afterwards identical requests give identical bytes, equal to
    those after a fresh registration of the same final image."""
    styles = [_u8(rng, 32, 32) for _ in range(6)]
    cbytes = _png(_u8(rng, 48, 48))

    def register(i):
        return _post(server + "/style/stress", _png(styles[i % 6]))[0]

    def stylize(_):
        return _post(server + "/stylize?style=stress", cbytes)[0]

    with ThreadPoolExecutor(6) as ex:
        codes = list(ex.map(register, range(12))) + list(ex.map(stylize, range(12)))
    assert all(c == 200 for c in codes), codes
    final = styles[3]
    assert _post(server + "/style/stress", _png(final))[0] == 200
    a = _post(server + "/stylize?style=stress&alpha=0.9", cbytes)
    b = _post(server + "/stylize?style=stress&alpha=0.9", cbytes)
    assert a[0] == b[0] == 200 and a[1] == b[1]
    assert _post(server + "/style/stress", _png(final))[0] == 200
    c = _post(server + "/stylize?style=stress&alpha=0.9", cbytes)
    assert c[0] == 200 and c[1] == a[1]


def test_metrics_endpoint(engine, rng):
    srv, url = _start(serve.build_app(engine, lambda m: None))
    try:
        img = _png(_u8(rng, 40, 40))
        _post(url + "/style/m", img)
        assert _post(url + "/stylize?style=m", img)[0] == 200
        m = _get(url + "/metrics")
        assert m["stylize_requests"] == 1 and m["styles"] == 1
        assert m["latency_s"]["p50"] > 0
        _post(url + "/stylize?style=m", b"not an image")
        m2 = _get(url + "/metrics")
        assert m2["stylize_requests"] == 2 and m2["stylize_errors"] == 1
        assert m2["engine_queue"]["depth"] == 0 and m2["engine_queue"]["max"] >= 1
    finally:
        srv.shutdown()


def test_style_blend_over_http_equals_the_engine(server, engine, rng):
    a = _u8(rng, 48, 48)
    b = 255 - a
    _post(server + "/style/ba", _png(a))
    _post(server + "/style/bb", _png(b))
    img = _u8(rng, 40, 40)
    code, body, ctype = _post(server + "/stylize?style=ba:0.6+bb:0.4", _png(img))
    assert code == 200 and ctype == "image/jpeg"
    key, proxy = engine.blend_styles([a, b], [0.6, 0.4])
    want = engine.stylize(img, proxy, style_key=key, as_uint8=True)
    assert body == tnc.encode_jpeg(want, quality=95)
    code, body, _ = _post(server + "/stylize?style=ba:0.6+nope:0.4", _png(img))
    assert code == 400 and b"nope" in body
    code, body, _ = _post(server + "/stylize?style=ba:x+bb:0.4", _png(img))
    assert code == 400 and b"weight" in body


def test_response_equals_the_engines_direct_call(server, engine, rng):
    style, content = _u8(rng, 40, 56), _u8(rng, 36, 52)
    _post(server + "/style/direct", _png(style))
    for body_in in (_png(content), _jpeg(content)):
        code, body, ctype = _post(server + "/stylize?style=direct&alpha=0.8", body_in)
        decoded = tnc.decode_jpeg(body_in) if body_in[:2] == b"\xff\xd8" else content
        want = engine.stylize(decoded, style, alpha=0.8, as_uint8=True)
        assert code == 200 and ctype == "image/jpeg"
        assert body == tnc.encode_jpeg(want, quality=95)


def test_jpeg_without_the_codec_is_415_and_png_is_served(engine, rng, monkeypatch):
    """Where the native codec is not built, a JPEG body gets a 415 whose
    error is the codec's reason; PNG bodies are served as PNG, bit-equal to
    the engine's own uint8 result."""
    monkeypatch.setattr(tnc, "_lib", None)
    monkeypatch.setattr(tnc, "_reason", "native codec unavailable: no jpeglib.h")
    srv, url = _start(serve.build_app(engine, lambda m: None))
    try:
        assert _get(url + "/healthz")["codec"] == "native codec unavailable: no jpeglib.h"
        style, content = _u8(rng, 32, 32), _u8(rng, 30, 44)
        code, body, _ = _post(url + "/style/j", _jpeg(style))
        assert code == 415 and json.loads(body)["error"] == tnc.unavailable_reason()
        assert _post(url + "/style/p", _png(style))[0] == 200
        code, body, _ = _post(url + "/stylize?style=p", _jpeg(content))
        assert code == 415 and json.loads(body)["error"] == tnc.unavailable_reason()
        code, body, ctype = _post(url + "/stylize?style=p&alpha=0.5", _png(content))
        assert code == 200 and ctype == "image/png"
        np.testing.assert_array_equal(
            decode_png(body), engine.stylize(content, style, alpha=0.5, as_uint8=True))
        m = _get(url + "/metrics")
        assert m["stylize_requests"] == 2 and m["stylize_errors"] == 1
    finally:
        srv.shutdown()


def test_port_response_matches_the_reference_server(rng):
    """Same toy pyramid, same PNG request, ``transport="rgb"``: the decoded
    responses agree at PSNR >= 40 dB."""
    jp = _jax_pyramid(seed=5)
    je = JaxEngine(mode="toy", stages=(1,), pyramid=jp, transport="rgb")
    te = WCTEngine(mode="toy", stages=(1,), pyramid=_port_pyramid(jp), device="cpu",
                   transport="rgb")
    with np.load(os.path.join(REPO, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        content, style = d["content"][100:164, 200:296], d["style"][:64, :64]
    outs = []
    for handler in (jax_build_app(je, lambda m: None), serve.build_app(te, lambda m: None)):
        srv, url = _start(handler)
        try:
            assert _post(url + "/style/s", _png(style))[0] == 200
            code, body, ctype = _post(url + "/stylize?style=s&alpha=0.8", _png(content))
            assert code == 200
            outs.append(_decode(body, ctype).astype(np.float64))
        finally:
            srv.shutdown()
    assert outs[0].shape == outs[1].shape == content.shape
    mse = np.mean((outs[0] - outs[1]) ** 2)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) >= PSNR_MIN_DB


def test_warm_shapes_run_at_startup():
    logs = []
    serve.build_app(_toy_engine(), logs.append, warm_shapes=[(32, 48)])
    assert _wait_for(logs, "shape 32x48 warm"), logs


def test_streamed_jpeg_path_over_http(rng):
    """A fused-slab engine under ``transport="yuv420"`` serves baseline 4:2:0
    JPEGs through ``stylize_jpeg`` (streamed) or the assembled planes; both
    give the same bytes, a JPEG of the content's size."""
    content = _u8(rng, 64, 48)
    jpg = tnc.encode_jpeg_yuv420(*tnc.rgb_to_yuv420(content), quality=95)
    style = _u8(rng, 32, 32)
    bodies = []
    for stream_min in (0, 1 << 60):
        eng = WCTEngine(mode="toy", stages=(1,), pyramid=_port_pyramid(_jax_pyramid(3)),
                        device="cpu", slab_rows=16, stream_min_pix=stream_min,
                        transport="yuv420")
        srv, url = _start(serve.build_app(eng, lambda m: None))
        try:
            assert _post(url + "/style/s", _png(style))[0] == 200
            code, body, ctype = _post(url + "/stylize?style=s&alpha=0.8", jpg)
            assert code == 200 and ctype == "image/jpeg"
            assert _decode(body, ctype).shape == content.shape
            bodies.append(body)
        finally:
            srv.shutdown()
    assert bodies[0] == bodies[1]


def test_auto_transport_takes_planes_only_past_the_cutoff(engine, rng, monkeypatch):
    """``transport="auto"`` with ``_YUV_AUTO_PIX = None`` never takes the
    planes path (the reference's comparison against the cutoff would raise
    on None); with a cutoff, JPEGs at or above it do."""
    assert engine.transport == "auto" and tengine._YUV_AUTO_PIX is None
    calls = []
    orig = tnc.decode_jpeg_yuv420
    monkeypatch.setattr(tnc, "decode_jpeg_yuv420", lambda data: calls.append(1) or orig(data))
    srv, url = _start(serve.build_app(engine, lambda m: None))
    try:
        img = _u8(rng, 64, 64)
        _post(url + "/style/g", _png(img))
        assert _post(url + "/stylize?style=g", _jpeg(img))[0] == 200 and calls == []
        monkeypatch.setattr(tengine, "_YUV_AUTO_PIX", 1024)
        code, _, ctype = _post(url + "/stylize?style=g", _jpeg(img))
        assert code == 200 and ctype == "image/jpeg" and len(calls) == 1
        monkeypatch.setattr(tengine, "_YUV_AUTO_PIX", 64 * 64 + 1)
        assert _post(url + "/stylize?style=g", _jpeg(img))[0] == 200 and len(calls) == 1
    finally:
        srv.shutdown()


def test_gauged_lock_leaves_the_queue_when_its_wait_raises():
    """An interrupted wait (``acquire`` raising, as KeyboardInterrupt does
    while a request waits for the card) leaves ``depth`` where it was;
    ``max_depth`` still counts the thread that waited."""
    class _Interrupted:
        def acquire(self):
            raise KeyboardInterrupt

    lock = serve._GaugedLock()
    with lock:
        assert (lock.depth, lock.max_depth) == (1, 1)
    lock._lock = _Interrupted()
    with pytest.raises(KeyboardInterrupt):
        with lock:
            pass
    assert (lock.depth, lock.max_depth) == (0, 1)
