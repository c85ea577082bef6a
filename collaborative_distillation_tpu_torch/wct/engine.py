"""The 5-level WCT stylization cascade engine.

Plain per-stage path: for each stage k = 5..1, encode the style with ``e{k}``
and take its channel statistics (cached per style key), encode the content,
whiten and colour it (:func:`..ops.wct_transform.wct_transform`), decode
with ``d{k}``. With ``slab_rows`` the same cascade runs in shingled row slabs
(:mod:`.slab`), the ultra-resolution path. Inputs are reflect-padded to a
multiple of 16 before the cascade and cropped after it, so pool/upsample
round trips are exact at any resolution.

The host boundary: uint8 images cross the link as RGB or as JPEG-native
YCbCr 4:2:0 planes (``transport``), the planes and JPEG endpoints
(:meth:`WCTEngine.stylize_planes`, :meth:`WCTEngine.stylize_jpeg`, ...) take
and give planes or JPEG bytes, and :meth:`WCTEngine.stylize_pairs` overlaps
one pair's upload and another's readback with the cascade.

The engine runs on the GPU unless the caller passes ``device="cpu"``, which
takes every kernel's plain PyTorch version.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch

from ..data import native_codec
from ..models.vgg import apply_decoder, apply_decoder_pwct, apply_encoder
from ..models.zoo import load_pyramid
from ..ops.pad import reflect_index
from ..ops.wct_transform import feature_stats, wct_transform
from ..utils.colorspace import (rgb_to_yuv420_host, rgbf_to_yuv420_device,
                                yuv420_to_rgb_host, yuv420_to_rgbf_device)
from ..utils.transfer import fetch, push
from .slab import SlabCascade, _to_u8, build_fused_slab_cascade

__all__ = ["WCTEngine", "stage_style_stats", "stylize_stage", "stylize_stage_pwct",
           "stylize_cascade_fn", "resolve_device", "STYLE_CACHE_MAX", "TILED_MAX_SHARD_PIX"]

# style-statistics cache bound: (stage, key, shape) -> (mean, cov) entries
# are small (C <= 512: <= 1 MB each), but a long-lived server registering
# styles forever must not grow device memory without bound.
STYLE_CACHE_MAX = 64
# guard for the per-conv-halo sharded path (space > 1 WITHOUT slab_rows),
# which keeps every shard's full feature maps: beyond this many pixels per
# shard the engine refuses and points to slab_rows, whose slab-in-shard
# cascade exists for that regime. 16 MPix per shard is about a 4K image.
TILED_MAX_SHARD_PIX = 16 * 1024 * 1024
# transport="auto": uint8 images of at least this many pixels cross the link
# as YCbCr 4:2:0 planes (1.5 B/px) instead of RGB (3 B/px); None: never.
# From chip_smoke.py phase 6(c) on an H100: the RGB upload of a whole UHD
# image takes ~10 ms (push), so halving the bytes saves at most ~5 ms each
# way, far less than the host's 4:2:0 conversions cost (at 2048^2 the
# yuv420 wall was 793 ms against 110 ms for rgb; PERF.md).
_YUV_AUTO_PIX = None


class _CorruptJpeg(Exception):
    """The incremental decoder failed mid-stream (truncated or malformed
    entropy data past the header)."""


def resolve_device(device) -> torch.device:
    """``None`` means the GPU; asking for it without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on the GPU unless asked otherwise, and CUDA is not "
            "available; pass device='cpu' for the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {dev}")
    return dev


def _pad_to_multiple(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
    """Reflect-pad H and W to multiples of 16, bottom and right, as
    ``np.pad(mode="reflect")`` does."""
    _, h, w, _ = x.shape
    ph = (-h) % 16
    pw = (-w) % 16
    if ph:
        x = x.index_select(1, reflect_index(h, 0, ph, x.device))
    if pw:
        x = x.index_select(2, reflect_index(w, 0, pw, x.device))
    return x, (h, w)


def _on(stream):
    """``torch.cuda.stream(stream)``, or nothing for the CPU's None."""
    return nullcontext() if stream is None else torch.cuda.stream(stream)


def _recorded(stream):
    """An event recorded on ``stream`` now (None on the CPU)."""
    if stream is None:
        return None
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def stage_style_stats(enc_params, enc_spec, style: torch.Tensor):
    """Per-stage (mean, cov) of the style image's relu{k}_1 features; a batch
    of styles (N > 1) gets per-image statistics ((N, C), (N, C, C))."""
    feats = apply_encoder(enc_params, style, enc_spec, aux=False)["out"]
    if feats.shape[0] > 1:
        means, covs = zip(*(feature_stats(f) for f in feats))
        return torch.stack(means), torch.stack(covs)
    return feature_stats(feats)


def stylize_stage(enc_params, dec_params, enc_spec, dec_spec, img, s_mean, s_cov,
                  alpha, method: str, newton_iters: int = 24) -> torch.Tensor:
    """encode -> WCT -> decode for one pyramid level (WCT.py styleTransfer)."""
    cf = apply_encoder(enc_params, img, enc_spec, aux=False)["out"]
    csf = wct_transform(cf, s_mean, s_cov, alpha, method=method,
                        newton_iters=newton_iters)
    return apply_decoder(dec_params, csf, dec_spec)["out"]


def stylize_stage_pwct(enc_params, dec_params, enc_spec, dec_spec, img, s_mean, s_cov,
                       alpha, method: str, newton_iters: int = 24) -> torch.Tensor:
    """Photo-WCT variant of :func:`stylize_stage`: the encoder's pool argmax
    indices drive max-unpooling in the decoder, whose last conv has no ReLU
    (structure-preserving; the reference's forward_pwct paths,
    model_cd.py:443-449/621-635)."""
    feats = apply_encoder(enc_params, img, enc_spec, aux=False, with_pool_argmax=True)
    csf = wct_transform(feats["out"], s_mean, s_cov, alpha, method=method,
                        newton_iters=newton_iters)
    return apply_decoder_pwct(dec_params, csf, dec_spec, feats)


def stylize_cascade_fn(pyramid, *, stages=(5, 4, 3, 2, 1), method: str = "eigh",
                       newton_iters: int = 24):
    """The whole cascade as one function of tensors: returns ``f(params,
    content, style, alpha)``, ``params`` as ``{stage: {"enc", "dec"}}`` (a
    pyramid serves), content and style padded NHWC maps on one device. Each
    stage takes the style's statistics afresh: no cache, no padding, no
    crop, no clip. The oracle the engine's paths are held to."""
    specs = {k: (pyramid[k]["enc_spec"], pyramid[k]["dec_spec"]) for k in stages}

    def f(params, content, style, alpha):
        img = content
        for k in stages:
            enc_spec, dec_spec = specs[k]
            s_mean, s_cov = stage_style_stats(params[k]["enc"], enc_spec, style)
            img = stylize_stage(params[k]["enc"], params[k]["dec"], enc_spec, dec_spec, img,
                                s_mean, s_cov, alpha, method, newton_iters)
        return img

    return f


class WCTEngine:
    """User-facing stylization engine.

    >>> eng = WCTEngine(mode="16x")                  # on the GPU
    >>> out = eng.stylize(content_hw3, style_hw3, alpha=1.0)
    >>> WCTEngine(mode="16x", device="cpu")          # plain PyTorch path

    Handles padding, host <-> device transfer, style-statistics caching and
    multi-run cascades (``num_run``, WCT.py:120). ``pyramid`` takes an
    external ``{stage: {"enc_spec", "dec_spec", "enc", "dec"}}`` pyramid
    (e.g. from :func:`..utils.params.pyramid_from_jax`) instead of loading
    ``mode`` from the weight store.

    ``slab_rows`` > 0 routes single images through the row-slab cascade
    (:mod:`.slab`): the fused one (feature cache, cached style statistics)
    unless ``fused=False``, which takes the per-stage :class:`SlabCascade`.
    Images shorter than two margins take the plain path; a height whose last
    slab would recompute more than a quarter slab of its neighbour's rows
    gets an evenly dividing slab (``SlabCascade.pick_slab_rows``). A uint8
    or plane output of at least ``stream_min_pix`` pixels leaves the fused
    path's last stage to the streamed tail
    (:meth:`SlabCascade.stream_last_stage`).

    ``space`` > 1 cuts each image's rows into that many shards over
    ``devices``, a list of devices in shard order in which a device may stand
    more than once (``["cuda:0"] * 4``: four shards on one card;
    ``["cpu"] * 4`` with ``device="cpu"``: the CPU). Without ``devices`` the
    shards take the visible CUDA devices, one each, and the engine raises
    when there are fewer than ``space``. With ``slab_rows`` every shard
    streams through its whole windows of the single-card slab plan
    (:func:`..parallel.spatial.build_tiled_slab_cascade`); without, every
    conv exchanges one-row halos (:func:`..parallel.spatial.build_tiled_stylize_fn`):
    the rows, padded to 16 as on the plain path, are dealt to the shards in
    whole 16-row blocks (the remainder to the last shards), images of fewer
    blocks than shards and images over ``TILED_MAX_SHARD_PIX`` pixels per
    shard are refused. On both the style's statistics are taken whole on
    the engine's device and cached per style key, so no pad row beyond the
    plain path's enters them. Both are per-image; the result is joined on
    the engine's device.

    ``transport``: how uint8 images cross the host link. ``"rgb"``: 3 bytes
    per pixel, bit-exact. ``"yuv420"``: JPEG-native YCbCr 4:2:0 planes, 1.5
    bytes per pixel, converted on the host (native codec) and on the device;
    the result differs from RGB transport by chroma-box rounding. ``"auto"``
    (default): ``"yuv420"`` for uint8 images of at least ``_YUV_AUTO_PIX``
    pixels, else ``"rgb"``; float input always goes as it is.
    """

    def __init__(self, mode: str = "16x", weights_root: str | None = None, *,
                 method: str = "eigh", newton_iters: int = 24,
                 stages=(5, 4, 3, 2, 1), pyramid=None, device=None,
                 slab_rows: int = 0, fused: bool = True,
                 stream_min_pix: int = 8 * 1024 * 1024, space: int = 0, devices=None,
                 transport: str = "auto"):
        if method not in ("eigh", "newton"):
            raise ValueError(f"unknown WCT method {method!r}")
        if transport not in ("auto", "rgb", "yuv420"):
            raise ValueError(
                f"transport must be 'auto', 'rgb' or 'yuv420', got {transport!r}")
        self.device = resolve_device(device)
        self.mode = mode
        self.method = method
        self.newton_iters = newton_iters
        self.transport = transport
        self.last_timings: dict = {}   # filled by stylize(timed=True)
        self.stages = tuple(stages)
        if pyramid is not None:
            def to_dev(tree):
                return {n: {k: torch.as_tensor(a).to(self.device, torch.float32)
                            for k, a in leaf.items()} for n, leaf in tree.items()}
            self.pyramid = {k: {**v, "enc": to_dev(v["enc"]), "dec": to_dev(v["dec"])}
                            for k, v in pyramid.items()}
        else:
            self.pyramid = load_pyramid(mode, weights_root, stages=self.stages,
                                        device=self.device)
        self._style_cache: OrderedDict = OrderedDict()  # LRU, STYLE_CACHE_MAX
        # guards _style_cache only: a server touches the cache from
        # registration threads (invalidate_style) while stylize threads
        # insert and evict; unsynchronized OrderedDict mutation corrupts it
        self._cache_lock = threading.Lock()
        self.stream_min_pix = stream_min_pix
        self.slab = None
        self.space = space if space and space > 1 else 0
        if devices is not None and not self.space:
            raise ValueError("devices lists the row shards' devices and needs space > 1; "
                             "the engine's own device is `device`")
        self.fused = bool(slab_rows) and fused and not self.space
        self._fused_fns: dict = {}  # (slab_rows, tail_stats) -> fused cascade
        self._tiled_fn = None
        self._tiled_slab = 0   # the sharded slab cascade's effective slab size
        if slab_rows and not self.space:
            self.slab = SlabCascade(self.pyramid, stages=self.stages,
                                    slab_rows=slab_rows, method=method,
                                    newton_iters=newton_iters)
        if self.space:
            # imported here: parallel/spatial.py builds on this package's slab.py
            from ..parallel.mesh import make_mesh
            from ..parallel.spatial import build_tiled_slab_cascade, build_tiled_stylize_fn
            self.mesh = make_mesh(space=self.space, devices=devices)
            kw = dict(stages=self.stages, method=method, newton_iters=newton_iters)
            if slab_rows:
                # memory-bounded path: slab streaming inside each row shard
                self._tiled_fn = build_tiled_slab_cascade(
                    self.pyramid, self.mesh, slab_rows=slab_rows,
                    external_style_stats=True, **kw)
                self._tiled_slab = self._tiled_fn.slab_rows
            else:
                self._tiled_fn = build_tiled_stylize_fn(self.pyramid, self.mesh, **kw)

    # -- style statistics ------------------------------------------------

    def invalidate_style(self, style_key) -> None:
        """Drop cached statistics for a style key (call when re-registering a
        different image under the same name). Thread-safe."""
        with self._cache_lock:
            for key in [k for k in self._style_cache if k[1] == style_key]:
                del self._style_cache[key]

    def _cache_put(self, key, stats) -> None:
        with self._cache_lock:
            self._style_cache[key] = stats
            while len(self._style_cache) > STYLE_CACHE_MAX:
                self._style_cache.popitem(last=False)

    def _cached(self, tag, style_key, style: torch.Tensor, compute):
        """``compute()``, LRU-cached under ``(tag, style_key, shape)`` when
        ``style_key`` is given."""
        if style_key is None:
            return compute()
        key = (tag, style_key, tuple(style.shape))
        with self._cache_lock:
            if key in self._style_cache:
                self._style_cache.move_to_end(key)
                return self._style_cache[key]
        stats = compute()
        self._cache_put(key, stats)
        return stats

    def _style_stats(self, k, style: torch.Tensor, cache_key=None):
        p = self.pyramid[k]
        return self._cached(k, cache_key, style,
                            lambda: stage_style_stats(p["enc"], p["enc_spec"], style))

    def _fused_style_stats(self, style: torch.Tensor, style_key=None):
        """Per-stage {k: (mean, cov)} for the fused slab cascade, LRU-cached
        under ``("fused", style_key, shape)``."""
        return self._cached("fused", style_key, style,
                            lambda: {k: self._style_stats(k, style) for k in self.stages})

    @torch.inference_mode()
    def blend_styles(self, styles, weights=None, *, style_keys=None):
        """Precompute statistics for a weighted blend of styles.

        Returns ``(style_key, proxy_style)``: pass them to :meth:`stylize` as
        the style image and key. The proxy is a tiny black image whose encode
        is skipped because the blended statistics are already cached under
        the returned key. Per stage, the target mean and covariance are the
        weighted sums of the per-style statistics (a convex combination of
        PSD matrices is PSD). Per-style statistics are cached under
        ``style_keys`` entries when given.
        """
        n = len(styles)
        if n == 0:
            raise ValueError("blend_styles needs at least one style")
        w = (np.full(n, 1.0 / n) if weights is None
             else np.asarray(weights, np.float64))
        if len(w) != n or (w < 0).any() or w.sum() <= 0:
            raise ValueError(f"bad blend weights {weights!r}")
        w = w / w.sum()
        if style_keys is None:
            style_keys = [None] * n
        if self.slab is not None and not self.fused:
            raise ValueError("style blending needs the fused slab path (fused=True): "
                             "the per-stage slab cascade re-encodes the raw style")
        if self._tiled_fn is not None and not self._tiled_slab:
            raise ValueError("style blending is refused on the per-conv sharded path "
                             "(space without slab_rows), whose reference stylizes with "
                             "the black proxy there; construct the engine with slab_rows")
        if all(k is not None for k in style_keys):
            blend_key = "blend:" + "+".join(
                f"{k}:{wi:.4f}" for k, wi in zip(style_keys, w))
        else:
            blend_key = "blend:" + uuid.uuid4().hex
        proxy = np.zeros((16, 16, 3), np.float32)
        proxy_shape = (1, 16, 16, 3)
        dev = [self._prep(s) for s in styles]
        blends = {}
        for k in self.stages:
            per_k = [self._style_stats(k, d, cache_key=sk)
                     for d, sk in zip(dev, style_keys)]
            m = sum(float(wi) * p[0] for wi, p in zip(w, per_k))
            c = sum(float(wi) * p[1] for wi, p in zip(w, per_k))
            blends[k] = (m, c)
            self._cache_put((k, blend_key, proxy_shape), (m, c))
        if self.fused:
            self._cache_put(("fused", blend_key, proxy_shape), blends)
        return blend_key, proxy

    def stylize_multi(self, content, styles, weights=None, alpha: float = 1.0,
                      *, style_keys=None, **kw):
        """Stylize with a weighted blend of styles (see :meth:`blend_styles`)."""
        key, proxy = self.blend_styles(styles, weights, style_keys=style_keys)
        return self.stylize(content, proxy, alpha, style_key=key, **kw)

    # -- host <-> device ---------------------------------------------------

    def _prep(self, image) -> torch.Tensor:
        """Host or device image, (H, W, 3) or (N, H, W, 3), uint8 or float ->
        padded float32 NHWC batch on the engine's device (a host array
        crosses the link through :func:`..utils.transfer.push`)."""
        x = (push(image, self.device) if isinstance(image, np.ndarray)
             else torch.as_tensor(image).to(self.device))
        if x.dim() == 3:
            x = x[None]
        x = self._u8_to_float(x) if x.dtype == torch.uint8 else x.float()
        return _pad_to_multiple(x)[0]

    def _to_device(self, content, style, transport: str | None = None):
        """Upload one pair: ``(img, sty, squeeze, orig_hw, transport)``, the
        padded device batches and ``transport`` resolved: ``"auto"`` is
        decided here, from the content's dtype and size, and reused for the
        output leg, so lossless float or RGB input never gets a 4:2:0
        output."""
        transport = transport or self.transport
        if transport == "auto":
            big = (isinstance(content, np.ndarray) and content.dtype == np.uint8
                   and _YUV_AUTO_PIX is not None
                   and content.shape[-3] * content.shape[-2] >= _YUV_AUTO_PIX)
            transport = "yuv420" if big else "rgb"
        squeeze = content.ndim == 3
        if squeeze:
            content = content[None]
        orig = (content.shape[1], content.shape[2])
        if (transport == "yuv420" and isinstance(content, np.ndarray)
                and content.dtype == np.uint8):
            # JPEG-native 4:2:0 planes across the link (1.5 B/px); the style
            # is small and stays RGB
            ph, pw = (-orig[0]) % 2, (-orig[1]) % 2
            if ph or pw:
                content = np.pad(content, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
            img = yuv420_to_rgbf_device(*self._upload_yuv420(content))
            img = _pad_to_multiple(img)[0]
        else:
            # float (or device) content cannot take the 4:2:0 path, and the
            # two legs must agree: lossless input never gets a lossy output
            transport = "rgb"
            img = self._prep(content)
        return img, self._prep(style), squeeze, orig, transport

    def _upload_yuv420(self, content: np.ndarray, *, bands: int | None = None):
        """RGB uint8 (N, H, W, 3), H and W even -> device (Y, CbCr) planes.

        One big image is converted in bands: the native RGB -> 4:2:0 loop
        converts band i while bands < i are copied to the card (two uploads
        in flight). Bands are even-height, so the chroma boxes, and so the
        planes, are those of the whole-image conversion."""
        n, h, w, _ = content.shape
        if bands is None:
            bands = 4 if n == 1 and h >= 1024 else 1
        if bands <= 1:
            y, cbcr = rgb_to_yuv420_host(content)
            return push(y, self.device), push(cbcr, self.device)
        rows = -(-h // bands)
        rows += rows % 2  # even band heights keep chroma boxes band-local
        return self._upload_plane_bands(rgb_to_yuv420_host(content[:, a:a + rows])
                                        for a in range(0, h, rows))

    def _upload_plane_bands(self, bands):
        """Upload an in-order iterable of host ``(y, cbcr)`` plane bands with
        two uploads in flight while the producer goes on making bands;
        returns the concatenated device planes. Before band i is taken, band
        i-2's upload has left the host, so at most ~3 bands are held there."""
        stream = (torch.cuda.current_stream(self.device) if self.device.type == "cuda"
                  else None)

        def up(a):
            return push(a, self.device, stream=stream)

        dev = []
        with ThreadPoolExecutor(2) as pool:
            for yb, cb in bands:
                if len(dev) >= 2:
                    dev[-2][0].result()
                    dev[-2][1].result()
                dev.append((pool.submit(up, yb), pool.submit(up, cb)))
            y = torch.cat([fy.result() for fy, _ in dev], dim=1)
            c = torch.cat([fc.result() for _, fc in dev], dim=1)
        return y, c

    def _from_device(self, img, orig_hw, squeeze: bool, as_uint8: bool,
                     transport: str | None = None) -> np.ndarray:
        """The (padded) device result -> the host image cropped to
        ``orig_hw``: float in [0, 1] or uint8, RGB across the link or, with
        ``transport="yuv420"`` and uint8, 4:2:0 planes reassembled on the
        host. A host array (a streamed result) is only cropped."""
        transport = transport or self.transport
        if transport == "auto":  # internal callers pass the input side's
            transport = "rgb"    # resolution; direct callers get lossless
        if transport == "yuv420" and as_uint8 and not isinstance(img, np.ndarray):
            y, cbcr = rgbf_to_yuv420_device(img)
            img = yuv420_to_rgb_host(fetch(y), fetch(cbcr))
        img = img[:, :orig_hw[0], :orig_hw[1]]
        if not isinstance(img, np.ndarray):
            img = fetch(_to_u8(img) if as_uint8 else torch.clamp(img, 0.0, 1.0))
        return img[0] if squeeze else img

    def _sync(self) -> None:
        """Wait for every card this engine uses (``stylize(timed=True)``)."""
        devices = {self.device, *(self.mesh.devices[0] if self.space else ())}
        for d in devices:
            if torch.device(d).type == "cuda":
                torch.cuda.synchronize(d)

    @torch.inference_mode()
    def stylize(self, content, style, alpha: float = 1.0, *, num_run: int = 1,
                style_key=None, as_uint8: bool = False, pwct: bool = False,
                transport: str | None = None, timed: bool = False) -> np.ndarray:
        """Stylize one content/style pair (or a batch). Inputs: (H, W, 3) or
        (N, H, W, 3), float in [0, 1] or uint8 in [0, 255]; returns the same
        rank, clipped to [0, 1] (float) or rounded to uint8 (``as_uint8``).
        uint8 images cross the host link as 3 bytes per pixel and are
        converted on the device; ``transport`` ("auto", "rgb", "yuv420")
        overrides the engine's for this call (see the class).

        ``pwct=True`` runs photo-WCT (:func:`stylize_stage_pwct`) on the
        plain per-stage path; slab and sharded engines refuse it. The
        style's statistics keep the standard encoder and its cache.

        ``timed=True`` waits for the card after the upload and after the
        cascade and records the legs' wall times in ``self.last_timings``
        (``upload_s``, ``compute_s``, ``readback_s``, ``total_s``). The
        waits serialize legs that otherwise overlap, so a timed call is a
        breakdown of where the time goes, not the fastest total.
        """
        t0 = time.perf_counter() if timed else 0.0
        img, sty, squeeze, orig_hw, transport = self._to_device(content, style, transport)
        if timed:
            self._sync()
            t1 = time.perf_counter()
        out = self._run(img, sty, alpha, num_run=num_run, style_key=style_key,
                        as_uint8=as_uint8, transport=transport, pwct=pwct)
        if timed:
            self._sync()
            t2 = time.perf_counter()
        out = self._from_device(out, orig_hw, squeeze, as_uint8, transport)
        if timed:
            t3 = time.perf_counter()
            self.last_timings = {
                "upload_s": round(t1 - t0, 3), "compute_s": round(t2 - t1, 3),
                "readback_s": round(t3 - t2, 3), "total_s": round(t3 - t0, 3)}
        return out

    @torch.inference_mode()
    def stylize_device(self, content: torch.Tensor, style: torch.Tensor,
                       alpha: float = 1.0, *, num_run: int = 1,
                       style_key=None, pwct: bool = False) -> torch.Tensor:
        """Device-resident stylization: float (N, H, W, 3) or (H, W, 3)
        tensors in, a float (N, H, W, 3) tensor on the engine's device out,
        cropped to the input's H, W and clipped to [0, 1]; no host transfer.
        ``pwct`` as in :meth:`stylize`."""
        h, w = content.shape[-3:-1]
        out = self._run(self._prep(content), self._prep(style), alpha,
                        num_run=num_run, style_key=style_key, pwct=pwct)
        return torch.clamp(out[:, :h, :w], 0.0, 1.0)

    # -- the planes and JPEG endpoints ----------------------------------------

    @staticmethod
    def _check_planes(y) -> None:
        if y.ndim != 2 or y.shape[0] % 2 or y.shape[1] % 2:
            raise ValueError(f"a Y plane of even height and width is needed, got "
                             f"shape {y.shape}")

    @torch.inference_mode()
    def stylize_planes(self, y: np.ndarray, cbcr: np.ndarray, style, alpha: float = 1.0,
                       *, num_run: int = 1, style_key=None) -> tuple[np.ndarray, np.ndarray]:
        """JPEG-native endpoint: the content as YCbCr 4:2:0 planes (Y (H, W)
        uint8, CbCr (H/2, W/2, 2) uint8, what
        ``native_codec.decode_jpeg_yuv420`` reads out of a JPEG), the
        stylized planes back (for ``encode_jpeg_yuv420``). The host does no
        pixel math: the card converts, stylizes and converts back. H and W
        must be even."""
        self._check_planes(y)
        orig_hw = y.shape
        img = yuv420_to_rgbf_device(push(y[None], self.device), push(cbcr[None], self.device))
        img = _pad_to_multiple(img)[0]
        out = self._run(img, self._prep(style), alpha, num_run=num_run,
                        style_key=style_key, emit_planes=True)
        if isinstance(out, tuple):  # streamed: host planes already
            yo, co = out
            return yo[0, :orig_hw[0], :orig_hw[1]], co[0, :orig_hw[0] // 2, :orig_hw[1] // 2]
        yo, co = rgbf_to_yuv420_device(out[:, :orig_hw[0], :orig_hw[1]])
        return fetch(yo)[0], fetch(co)[0]

    @torch.inference_mode()
    def stylize_planes_jpeg(self, y: np.ndarray, cbcr: np.ndarray, style,
                            alpha: float = 1.0, *, style_key=None,
                            quality: int = 95) -> bytes | None:
        """Stylize 4:2:0 planes and return the encoded JPEG bytes, each
        streamed band entropy-encoded (native incremental encoder, GIL
        released) while later bands are still computed and fetched.

        Returns None where this engine or input cannot stream (no fused slab
        path, below ``stream_min_pix``, the native codec unavailable):
        callers take :meth:`stylize_planes` + ``encode_jpeg_yuv420`` then,
        whose bytes are the same.
        """
        self._check_planes(y)
        h, w = y.shape
        if not self.fused or h * w < self.stream_min_pix:
            return None
        img = yuv420_to_rgbf_device(push(y[None], self.device), push(cbcr[None], self.device))
        return self._run_to_jpeg(img, style, alpha, style_key=style_key, quality=quality,
                                 orig_hw=(h, w))

    @torch.inference_mode()
    def stylize_jpeg(self, data: bytes, style, alpha: float = 1.0, *,
                     style_key=None, quality: int = 95) -> bytes | None:
        """JPEG bytes in, JPEG bytes out, streamed both ways: the content is
        entropy-decoded in row bands (native incremental decoder, GIL
        released) while earlier bands already cross the link, stylized, and
        the streamed output bands are entropy-encoded while later ones
        fetch. The host never does pixel math and never holds the whole
        image in either direction.

        Returns None where the input is not a baseline 4:2:0 JPEG, it is
        corrupt past its header, or this engine or input cannot stream (see
        :meth:`stylize_planes_jpeg`): callers take ``decode_jpeg_yuv420`` +
        :meth:`stylize_planes` (+ encode) then.
        """
        if not self.supports_streamed_jpeg():
            return None  # before opening a decoder for nothing
        reader = native_codec.jpeg_yuv420_reader(data)
        if reader is None:
            return None
        h, w = reader.h, reader.w
        if h * w < self.stream_min_pix:
            reader.close()
            return None
        band = max(16, (-(-h // 4) // 16) * 16)

        def bands():
            a = 0
            while a < h:
                r = min(band, h - a)
                planes = reader.read(r)
                if planes is None:
                    raise _CorruptJpeg  # decode error mid-stream
                yield planes[0][None], planes[1][None]
                a += r

        try:
            y_dev, c_dev = self._upload_plane_bands(bands())
        except _CorruptJpeg:
            return None  # the caller takes the whole path
        img = yuv420_to_rgbf_device(y_dev, c_dev)
        return self._run_to_jpeg(img, style, alpha, style_key=style_key, quality=quality,
                                 orig_hw=(h, w))

    def supports_streamed_jpeg(self) -> bool:
        """Can :meth:`stylize_jpeg` stream on this engine at all? Servers ask
        before taking an engine lock and opening a decoder for nothing."""
        return self.fused

    def _run_to_jpeg(self, img, style, alpha, *, style_key, quality,
                     orig_hw) -> bytes | None:
        """The JPEG endpoints' shared tail: pad, run the cascade with a
        streamed plane sink feeding the incremental encoder, or encode
        assembled planes where the cascade did not stream."""
        orig_h, orig_w = orig_hw
        writer = native_codec.jpeg_yuv420_writer(orig_w, orig_h, quality)
        if writer is None:
            return None
        state = {"row": 0, "ok": True, "buf": None, "written": 0}

        def sink(band):
            if not state["ok"]:
                return
            yb, cb = band  # padded-width band planes, rows even
            r0 = state["row"]
            state["row"] += yb.shape[1]
            take = min(yb.shape[1], orig_h - r0)  # drop pad rows past orig H
            if take <= 0:
                return
            yb = yb[0, :take, :orig_w]
            cb = cb[0, :take // 2, :orig_w // 2]
            if state["buf"] is not None:  # carry from a band not MCU-aligned
                py, pc = state["buf"]
                yb = np.concatenate([py, yb])
                cb = np.concatenate([pc, cb])
                state["buf"] = None
            # intermediate writes must be 16-row (MCU) aligned; the final
            # write (reaching orig_h) may be any even height
            if state["written"] + yb.shape[0] == orig_h:
                n = yb.shape[0]
            else:
                n = (yb.shape[0] // 16) * 16
            if n:
                if not writer.write(yb[:n], cb[:n // 2]):
                    state["ok"] = False
                    return
                state["written"] += n
            if yb.shape[0] > n:
                state["buf"] = (yb[n:], cb[n // 2:])

        img = _pad_to_multiple(img)[0]
        out = self._run(img, self._prep(style), alpha, num_run=1, style_key=style_key,
                        emit_planes=True, band_sink=sink)
        if (out is None and state["ok"] and state["buf"] is None
                and state["written"] == orig_h):
            return writer.finish()
        writer.close()
        if out is None:
            return None  # streamed, but a band failed: the caller falls back
        # not streamed (the small-image bypass): encode assembled planes
        yd, cd = rgbf_to_yuv420_device(out[:, :orig_h, :orig_w])
        return native_codec.encode_jpeg_yuv420(fetch(yd)[0], fetch(cd)[0], quality=quality)

    # -- many pairs ---------------------------------------------------------

    def stylize_pairs(self, pairs, alpha: float = 1.0, *, num_run: int = 1,
                      style_keys=None, as_uint8: bool = True):
        """Pipelined stylization of many (content, style) pairs; yields the
        results in order.

        Three overlapping legs per pair: pair i+1's upload and pair i-1's
        readback cross the link while pair i computes. On the card the
        uploader and the fetcher are threads with CUDA streams of their own:
        the cascade's stream waits for an upload's event, the fetcher's
        stream for the cascade's, and every tensor that crosses streams is
        recorded on the stream that reads it. At most two device images are
        in flight, and at most one pair is uploaded ahead, so ``pairs`` may
        be a lazy iterable of any length. ``style_keys``: per-pair
        statistics-cache keys, as many as the pairs (strict). The cascade
        runs whole (no streamed tail): the readback overlaps across pairs.
        """
        if style_keys is not None:
            # strict: a shorter keys iterable would silently cut the stream
            stream = iter(zip(pairs, style_keys, strict=True))
        else:
            stream = iter(zip(pairs, itertools.repeat(None)))
        cuda = self.device.type == "cuda"
        up_s, get_s = ((torch.cuda.Stream(self.device), torch.cuda.Stream(self.device))
                       if cuda else (None, None))
        compute = torch.cuda.current_stream(self.device) if cuda else None

        @torch.inference_mode()
        def prep():
            item = next(stream, None)
            if item is None:
                return None
            (c, s), key = item
            with _on(up_s):
                r = self._to_device(c, s)
                return (*r, key, _recorded(up_s))

        @torch.inference_mode()
        def get(out, done, orig_hw, squeeze, transport):
            with _on(get_s):
                if done is not None:
                    get_s.wait_event(done)
                    if isinstance(out, torch.Tensor):
                        out.record_stream(get_s)
                return self._from_device(out, orig_hw, squeeze, as_uint8, transport)

        with ThreadPoolExecutor(1) as uploader, ThreadPoolExecutor(1) as fetcher:
            nxt = uploader.submit(prep)
            fetches = []
            while True:
                r = nxt.result()
                if r is None:
                    break
                img, sty, squeeze, orig_hw, transport, key, ready = r
                nxt = uploader.submit(prep)
                if ready is not None:
                    compute.wait_event(ready)
                    img.record_stream(compute)
                    sty.record_stream(compute)
                with torch.inference_mode():
                    out = self._run(img, sty, alpha, num_run=num_run, style_key=key,
                                    as_uint8=as_uint8, transport=transport, stream_ok=False)
                fetches.append(fetcher.submit(get, out, _recorded(compute), orig_hw,
                                              squeeze, transport))
                del img, sty, out
                # at most two device images in flight; results leave in order
                if len(fetches) >= 2:
                    yield fetches.pop(0).result()
            for f in fetches:
                yield f.result()

    # -- the cascade ----------------------------------------------------------

    def _fused_fn(self, slab: int, tail: bool):
        key = (slab, tail)
        if key not in self._fused_fns:
            self._fused_fns[key] = build_fused_slab_cascade(
                self.pyramid, stages=self.stages, slab_rows=slab, method=self.method,
                newton_iters=self.newton_iters, external_style_stats=True,
                tail_stats=tail)
        return self._fused_fns[key]

    def _run(self, img, sty, alpha, *, num_run: int, style_key, as_uint8: bool = False,
             transport: str | None = None, stream_ok: bool = True,
             emit_planes: bool = False, band_sink=None, pwct: bool = False):
        """The cascade on padded device inputs: the (padded) device image,
        or where the fused slab path streamed its last stage to the host,
        its host result: uint8 RGB (``as_uint8``; over 4:2:0 planes with
        ``transport="yuv420"``), host planes (``emit_planes``), or None
        after feeding every band to ``band_sink``. ``stream_ok=False`` keeps
        the cascade whole (:meth:`stylize_pairs` overlaps readbacks across
        pairs itself). ``pwct``: photo-WCT, on the plain path only."""
        if pwct and (self.slab is not None or self._tiled_fn is not None):
            raise ValueError(
                "pwct=True is only supported on the plain per-stage path; "
                "construct the engine without slab_rows/space for photo-WCT")
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=self.device)
        if ((self.slab is not None or self._tiled_fn is not None)
                and (img.shape[0] > 1 or sty.shape[0] > 1)):
            raise ValueError("the slab and sharded paths are per-image (their statistics "
                             "would pool the batch); stylize the images one at a time "
                             "or use stylize_pairs for cross-pair pipelining")
        if self._tiled_fn is not None:
            return self._run_tiled(img, sty, alpha, num_run=num_run, style_key=style_key)
        if self.slab is None or img.shape[1] < 2 * self.slab.margin:
            # no slabs, or an image smaller than one slab's margins
            return self._run_plain(img, sty, alpha, num_run=num_run, style_key=style_key,
                                   pwct=pwct)
        if not self.fused:
            for i in range(num_run):
                img = self.slab.stylize(img, sty, alpha,
                                        to_host_uint8=as_uint8 and i == num_run - 1)
            return img
        h = img.shape[1]
        slab = self.slab.slab_rows
        if -(-h // slab) * slab - h > slab // 4:
            # awkward height: an evenly dividing slab size, so that the last
            # window recomputes less of its neighbour's rows
            slab = SlabCascade.pick_slab_rows(h, slab, self.slab.margin,
                                              self.slab.down_max)
        sstats = self._fused_style_stats(sty, style_key)
        if (stream_ok and (as_uint8 or emit_planes) and num_run == 1
                and img.shape[1] * img.shape[2] >= self.stream_min_pix):
            head = self._fused_fn(slab, True)
            h_img, t, c_mean, s_mean, kept = head(img, sstats, alpha)
            emit = "planes" if emit_planes else "yuv420" if transport == "yuv420" else "u8"
            return head.cascade.stream_last_stage(h_img, t, c_mean, s_mean, alpha,
                                                  kept=kept, emit=emit, on_band=band_sink)
        fn = self._fused_fn(slab, False)
        for _ in range(num_run):
            img = fn(img, sstats, alpha)
        return img

    def _shards(self, x: torch.Tensor, rows: list[int]) -> list[torch.Tensor]:
        """The rows of ``x`` cut into one contiguous shard per ``space``
        device, ``rows[d]`` rows each, each on its device."""
        return [part.contiguous().to(dev) for part, dev in
                zip(x.split(rows, dim=1), self.mesh.devices[0])]

    def _run_tiled(self, img, sty, alpha, *, num_run: int, style_key):
        """The row-sharded cascade: cut the rows, run, join on the engine's
        device. The style's statistics are taken once, whole, on the
        engine's device (cached per style key) and copied to the shards by
        the cascade. The caller crops the padding."""
        h = img.shape[1]
        if self._tiled_slab:
            # slabs inside shards: whole windows of the global plan per
            # shard, nothing padded
            from ..parallel.spatial import shard_rows
            rows = shard_rows(h, self._tiled_slab, self.space)
        else:
            rows = self._block_rows(h)
            # per-conv halos hold FULL per-shard feature maps, the O(H*W)
            # footprint the slab cascade exists to avoid: refuse
            # ultra-resolution inputs with a pointer, not an out-of-memory
            per_shard_pix = max(rows) * img.shape[2]
            if per_shard_pix > TILED_MAX_SHARD_PIX:
                raise ValueError(
                    f"{h}x{img.shape[2]} over space={self.space} leaves "
                    f"{per_shard_pix / 1e6:.0f} MPix of full-height feature maps per "
                    f"shard on the per-conv-halo path; construct the engine with "
                    f"slab_rows (memory-bounded slab-in-shard cascade) for images "
                    f"this large")
        sty = {k: self._style_stats(k, sty, cache_key=style_key) for k in self.stages}
        shards = self._shards(img, rows)
        for _ in range(num_run):
            shards = self._tiled_fn(shards, sty, alpha)
        return torch.cat([s.to(self.device) for s in shards], dim=1)

    def _block_rows(self, h: int) -> list[int]:
        """The per-conv path's cut of ``h`` rows (a multiple of 16): whole
        16-row blocks dealt out as evenly as they go, the remainder to the
        last shards, so that no shard holds a row past the plain path's
        padding and every shard's pools and upsamples stay local."""
        blocks, space = h // 16, self.space
        if blocks < space:
            raise ValueError(
                f"the per-conv sharded path deals whole 16-row blocks to its {space} "
                f"shards: an image of {h} padded rows has {blocks}; it needs at least "
                f"{16 * (space - 1) + 1} rows")
        return [16 * (blocks // space + (d >= space - blocks % space)) for d in range(space)]

    def _run_plain(self, img, sty, alpha, *, num_run: int, style_key, pwct: bool = False):
        stage = stylize_stage_pwct if pwct else stylize_stage
        for _ in range(num_run):
            for k in self.stages:
                s_mean, s_cov = self._style_stats(k, sty, cache_key=style_key)
                p = self.pyramid[k]
                img = stage(p["enc"], p["dec"], p["enc_spec"], p["dec_spec"], img, s_mean,
                            s_cov, alpha, self.method, self.newton_iters)
        return img

    @staticmethod
    def _u8_to_float(x: torch.Tensor) -> torch.Tensor:
        return x.float() / 255.0
