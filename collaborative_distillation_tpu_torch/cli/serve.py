"""Stylization server: an HTTP endpoint over a warm WCT engine.

    python -m collaborative_distillation_tpu_torch.cli.serve --mode 16x --port 8700

    POST /stylize?alpha=0.8&style=<name>   body: PNG or JPEG content image
    POST /stylize?style=a:0.7,b:0.3        a weighted blend of registered styles
    POST /style/<name>                     body: PNG or JPEG style image (registers
                                           it and precomputes its statistics)
    GET  /healthz                          liveness, engine config, device, codec
    GET  /styles                           registered style names
    GET  /metrics                          request counts, latency p50/p95, the
                                           engine lock's queue

The reference package's server on the port's engine, on the GPU unless
``--device cpu``. Image bodies are read by the port itself: PNG always,
JPEG by the codec of the engine's device (nvJPEG on the card, libjpeg on
the CPU; :mod:`..data.jpeg`); a JPEG body where that codec cannot load gets
a 415 whose error is the codec's reason. Responses are ``image/jpeg``
through the same codec where it loads and ``image/png`` otherwise
(``Content-Type`` says which), with a ``Server-Timing`` header that splits
the request into decode, cascade and encode milliseconds.

Requests serialize through one engine lock (one card); decode and encode
happen outside it, except on the JPEG-to-JPEG path
(``engine.stylize_jpeg``), which decodes and encodes inside (on the CPU its
banded entropy decode and encode overlap the locked transfers). Per-style
statistics are cached inside the engine under a generation-keyed name, so
the steady-state cost of a request is one content cascade. The engine takes
its defaults, as the reference's server does: with ``--slab_rows`` it folds
each encoder's ``conv0`` into its ``conv1_1`` (``WCTEngine(packed=None)``).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..data import jpeg
from ..data.jpeg_header import jpeg_dims
from ..data.png import encode_png
from ..utils.image import CodecUnavailable, decode_image


class _GaugedLock:
    """Engine lock with an observable queue: ``depth`` counts the threads
    waiting for or holding the device; /metrics reports it and its
    high-water mark, so a load test sees contention directly."""

    def __init__(self):
        self._lock = threading.Lock()
        self._meta = threading.Lock()
        self.depth = 0
        self.max_depth = 0

    def __enter__(self):
        with self._meta:
            self.depth += 1
            self.max_depth = max(self.max_depth, self.depth)
        try:
            self._lock.acquire()
        except BaseException:
            # an interrupted wait never held the lock: it leaves the queue
            with self._meta:
                self.depth -= 1
            raise
        return self

    def __exit__(self, *exc):
        self._lock.release()
        with self._meta:
            self.depth -= 1
        return False


def encode_response(out: np.ndarray, device=None) -> tuple[bytes, str]:
    """A stylized uint8 image -> (body, content type): JPEG (quality 95)
    through ``device``'s codec where it loads, PNG otherwise."""
    body = jpeg.encode_jpeg(out, device, quality=95) if jpeg.available(device) else None
    if body is not None:
        return body, "image/jpeg"
    return encode_png(out), "image/png"


def codec_state(device) -> str:
    """"available", or why the device's JPEG codec cannot load."""
    return "available" if jpeg.available(device) else jpeg.unavailable_reason(device)


def build_app(engine, log, *, max_styles: int = 256,
              warm_shapes: list[tuple[int, int]] | None = None):
    from ..wct import engine as engine_mod

    device = engine.device   # its codec reads and writes every JPEG here
    # LRU-bounded registry: a long-lived server registering styles forever
    # must not grow host memory (raw style images) or device memory (the
    # engine's statistics cache, itself LRU'd) without bound. Each
    # registration gets a fresh generation in its cache key: an in-flight
    # /stylize that read the previous image can only (re)cache statistics
    # under the old key, never poison the new registration.
    styles: OrderedDict[str, tuple[np.ndarray, str]] = OrderedDict()
    gen_counter = iter(range(1 << 62))
    lock = _GaugedLock()              # serializes device work (one card)
    registry_lock = threading.Lock()  # guards the styles dict only

    def register(name: str, arr: np.ndarray) -> str:
        with registry_lock:
            keyed = f"{name}#{next(gen_counter)}"
            old = styles.get(name)
            if name in styles:
                styles.move_to_end(name)
            styles[name] = (arr, keyed)
            evicted_keys = [old[1]] if old is not None else []
            while len(styles) > max_styles:
                evicted, (_, ekey) = styles.popitem(last=False)
                evicted_keys.append(ekey)
                log(f"style registry full: evicted {evicted!r}")
        for ekey in evicted_keys:   # frees cached statistics; the keys are dead
            engine.invalidate_style(ekey)
        return keyed

    def warm(keyed: str, arr: np.ndarray) -> None:
        # in the background: holding the engine lock from the registration
        # request would block every concurrent /stylize; requests arriving
        # before the warm-up ends queue on the lock and compute the
        # statistics themselves
        try:
            probe = np.zeros((32, 32, 3), np.uint8)
            with lock:
                engine.stylize(probe, arr, style_key=keyed)
            log(f"style {keyed!r} warm")
        except Exception as e:  # noqa: BLE001 — warm-up is best-effort
            log(f"style warm-up failed for {keyed!r}: {type(e).__name__}: {e}")

    def warm_shape(h: int, w: int) -> None:
        # run the cascade once at a canonical request shape, so the first
        # real request at it does not pay the first library calls there
        try:
            content = np.zeros((h, w, 3), np.uint8)
            probe_style = np.zeros((64, 64, 3), np.uint8)
            with lock:
                engine.stylize(content, probe_style, style_key="__shape_warm__",
                               as_uint8=True)
            log(f"shape {h}x{w} warm")
        except Exception as e:  # noqa: BLE001 — warm-up is best-effort
            log(f"shape warm-up failed for {h}x{w}: {type(e).__name__}: {e}")

    if warm_shapes:
        def _warm_all():
            for h, w in warm_shapes:
                warm_shape(h, w)
        threading.Thread(target=_warm_all, daemon=True).start()

    metrics_lock = threading.Lock()
    metrics = {"stylize_requests": 0, "stylize_errors": 0, "latencies": deque(maxlen=256)}

    def record_stylize(dt_s: float, ok: bool) -> None:
        with metrics_lock:
            metrics["stylize_requests"] += 1
            if ok:
                metrics["latencies"].append(dt_s)
            else:
                metrics["stylize_errors"] += 1

    def metrics_snapshot() -> dict:
        with metrics_lock:
            lats = sorted(metrics["latencies"])
            n_req = metrics["stylize_requests"]
            n_err = metrics["stylize_errors"]
        with registry_lock:
            n_styles = len(styles)
        out = {"stylize_requests": n_req, "stylize_errors": n_err,
               "styles": n_styles, "uptime_s": round(time.time() - t_start, 1)}
        if lats:
            out["latency_s"] = {
                "p50": round(lats[len(lats) // 2], 3),
                "p95": round(lats[min(len(lats) - 1, int(len(lats) * 0.95))], 3),
                "max": round(lats[-1], 3)}
        out["engine_queue"] = {"depth": lock.depth, "max": lock.max_depth}
        return out

    def planes_ok(data: bytes) -> bool:
        """Take the JPEG-native planes path? Only for JPEG bodies; never under ``transport="rgb"``
        (bit-exact RGB asked for); under ``"auto"`` only for JPEGs of at
        least ``_YUV_AUTO_PIX`` pixels, and never while that is None."""
        if engine.transport == "rgb" or not data.startswith(b"\xff\xd8"):
            return False
        if engine.transport == "auto":
            cutoff = engine_mod._YUV_AUTO_PIX
            dims = jpeg_dims(data) if cutoff is not None else None
            return dims is not None and dims[0] * dims[1] >= cutoff
        return True

    def stylize_body(data: bytes, style_arr, keyed, alpha: float):
        """(body, content type, {leg: seconds}) of one stylize request."""
        legs = {}
        t0 = time.perf_counter()
        if planes_ok(data):
            # JPEG-native: ordinary photo JPEGs store YCbCr 4:2:0, so the
            # planes are read straight out and the card does all pixel math.
            # The engine's JPEG-to-JPEG path first, where it has one (on the
            # CPU streamed: banded decode under the upload, banded encode
            # under the readback).
            if engine.supports_streamed_jpeg():
                with lock:
                    body = engine.stylize_jpeg(data, style_arr, alpha=alpha,
                                               style_key=keyed, quality=95)
                if body is not None:
                    return body, "image/jpeg", {"cascade": time.perf_counter() - t0}
            # the device's form: host planes on the CPU, device planes on the card
            planes = jpeg.decode_jpeg_yuv420(data, device)
            if planes is not None:
                legs["decode"] = time.perf_counter() - t0
                with lock:
                    t1 = time.perf_counter()
                    # big requests: the engine's JPEG tail; None -> the
                    # assembled planes
                    body = engine.stylize_planes_jpeg(*planes, style_arr, alpha=alpha,
                                                      style_key=keyed, quality=95)
                    if body is None:
                        yo, co = engine.stylize_planes(*planes, style_arr, alpha=alpha,
                                                       style_key=keyed,
                                                       on_device=device.type == "cuda")
                    legs["cascade"] = time.perf_counter() - t1
                t2 = time.perf_counter()
                ctype = "image/jpeg"
                if body is None:
                    body = jpeg.encode_jpeg_yuv420(yo, co, device, quality=95)
                if body is None:
                    # the encode failed: the stylized planes are in hand,
                    # so finish from them instead of running again
                    from ..utils.colorspace import yuv420_to_rgb_host
                    from ..utils.transfer import fetch
                    yo, co = (p if isinstance(p, np.ndarray) else fetch(p) for p in (yo, co))
                    body, ctype = encode_response(yuv420_to_rgb_host(yo[None], co[None])[0],
                                                  device)
                legs["encode"] = time.perf_counter() - t2
                return body, ctype, legs
        # the whole-image path: PNG, other JPEG samplings, rgb transport
        content = decode_image(data, name="the request body", device=device)
        t1 = time.perf_counter()
        legs["decode"] = t1 - t0
        with lock:
            t2 = time.perf_counter()
            out = engine.stylize(content, style_arr, alpha=alpha, style_key=keyed,
                                 as_uint8=True)
            legs["cascade"] = time.perf_counter() - t2
        t3 = time.perf_counter()
        body, ctype = encode_response(out, device)
        legs["encode"] = time.perf_counter() - t3
        return body, ctype, legs

    def resolve_style(name):
        """(style image, cache key) for ``style=``, a name or a blend
        ``a:0.6,b:0.4`` ('+' or spaces also separate; weights default
        equal); or (None, error dict) for a 400."""
        if name and re.search(r"[+,\s]", name):
            parts = [p.partition(":") for p in re.split(r"[+,\s]+", name) if p]
            with registry_lock:
                entries = [styles.get(nm) for nm, _, _ in parts]
                known = sorted(styles)
            missing = [p[0] for p, e in zip(parts, entries) if e is None]
            if missing:
                return None, {"error": f"unknown styles {missing} in blend {name!r}",
                              "styles": known}
            try:
                ws = [float(wtxt) if wtxt else 1.0 for _, _, wtxt in parts]
            except ValueError:
                return None, {"error": f"bad blend weights in {name!r} "
                                       f"(want style:weight+style:weight)"}
            # per-style statistics are warm in the engine's cache; the
            # blend itself is a few C x C adds under the device lock
            with lock:
                keyed, style_arr = engine.blend_styles(
                    [e[0] for e in entries], ws, style_keys=[e[1] for e in entries])
            return style_arr, keyed
        with registry_lock:
            entry = styles.get(name) if name else None
            if entry is not None:
                styles.move_to_end(name)
            known = sorted(styles)
        if entry is None:
            return None, {"error": f"unknown style {name!r}; register via POST /style/<name>",
                          "styles": known}
        return entry

    t_start = time.time()
    codec = {"codec": codec_state(device), "jpeg_codec": jpeg.codec_name(device)}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            log(f"{self.address_string()} {fmt % args}")

        def _send(self, code: int, body: bytes, ctype: str = "application/json",
                  headers: dict | None = None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode())

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"ok": True, "mode": engine.mode, "method": engine.method,
                                 "stages": list(engine.stages),
                                 "device": str(engine.device), **codec})
            elif path == "/styles":
                with registry_lock:
                    names = sorted(styles)
                self._json(200, {"styles": names})
            elif path == "/metrics":
                self._json(200, metrics_snapshot())
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            t0 = None
            try:
                if url.path.startswith("/style/"):
                    name = url.path[len("/style/"):]
                    if not name:
                        return self._json(400, {"error": "style name required"})
                    arr = decode_image(self._read_body(), name=f"style {name!r}",
                                       device=device)
                    keyed = register(name, arr)
                    threading.Thread(target=warm, args=(keyed, arr), daemon=True).start()
                    return self._json(200, {"registered": name, "size": list(arr.shape[:2]),
                                            "warming": True})
                if url.path == "/stylize":
                    t0 = time.time()
                    q = parse_qs(url.query)
                    alpha = float(q.get("alpha", ["1.0"])[0])
                    style_arr, keyed = resolve_style(q.get("style", [None])[0])
                    if style_arr is None:
                        t0 = None
                        return self._json(400, keyed)
                    body, ctype, legs = stylize_body(self._read_body(), style_arr, keyed,
                                                     alpha)
                    record_stylize(time.time() - t0, ok=True)
                    timing = ", ".join(f"{k};dur={v * 1e3:.3f}" for k, v in legs.items())
                    return self._send(200, body, ctype, {"Server-Timing": timing})
                return self._json(404, {"error": f"unknown path {url.path}"})
            except CodecUnavailable as e:
                # a JPEG where the device's codec cannot load: the client
                # can send PNG instead
                if t0 is not None:
                    record_stylize(time.time() - t0, ok=False)
                log(f"request refused: {e}")
                return self._json(415, {"error": jpeg.unavailable_reason(device),
                                        "accepts": ["image/png"]})
            except Exception as e:  # noqa: BLE001 — turn into a 500, keep serving
                if t0 is not None:
                    record_stylize(time.time() - t0, ok=False)
                log(f"request failed: {type(e).__name__}: {e}")
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", default="16x", choices=["original", "16x", "16x_kd2sd", "16x_base"])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8700, help="0 takes a free port (logged)")
    ap.add_argument("--method", default="eigh", choices=["eigh", "newton"])
    ap.add_argument("--slab_rows", type=int, default=0,
                    help="enable slab streaming for large inputs")
    ap.add_argument("--transport", default="auto", choices=["auto", "rgb", "yuv420"],
                    help="host<->device transport for images (yuv420 halves link bytes "
                         "for JPEG bodies: their 4:2:0 planes go to the cascade as read)")
    ap.add_argument("--weights_root", default="")
    ap.add_argument("--warm_shapes", default="",
                    help="comma-separated HxW request shapes to run once at startup "
                         "(e.g. '1080x1920,2160x3840')")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the cascade runs (default the GPU)")
    args = ap.parse_args(argv)
    warm_shapes = []
    for tok in filter(None, (t.strip() for t in args.warm_shapes.split(","))):
        try:
            h, w = tok.lower().split("x")
            warm_shapes.append((int(h), int(w)))
        except ValueError:
            ap.error(f"--warm_shapes: {tok!r} is not of the form HxW (e.g. 1080x1920)")

    from ..utils.logging import LogPrinter
    from ..wct.engine import WCTEngine, resolve_device

    device = resolve_device(args.device)   # before any work: no CUDA, no server
    log = LogPrinter(None, "serve", to_screen=True)
    engine = WCTEngine(mode=args.mode, weights_root=args.weights_root or None,
                       method=args.method, slab_rows=args.slab_rows,
                       transport=args.transport, device=device)
    server = ThreadingHTTPServer((args.host, args.port),
                                 build_app(engine, log, warm_shapes=warm_shapes))
    host, port = server.server_address[:2]
    log(f"serving mode={args.mode} on {device} at http://{host}:{port} (JPEG codec "
        f"{jpeg.codec_name(device)}: {codec_state(device)})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        log("shutting down")
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
