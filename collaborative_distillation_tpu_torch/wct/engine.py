"""The 5-level WCT stylization cascade engine.

Plain per-stage path: for each stage k = 5..1, encode the style with ``e{k}``
and take its channel statistics (cached per style key), encode the content,
whiten and colour it (:func:`..ops.wct_transform.wct_transform`), decode
with ``d{k}``. With ``slab_rows`` the same cascade runs in shingled row slabs
(:mod:`.slab`), the ultra-resolution path. Inputs are reflect-padded to a
multiple of 16 before the cascade and cropped after it, so pool/upsample
round trips are exact at any resolution.

The engine runs on the GPU unless the caller passes ``device="cpu"``, which
takes every kernel's plain PyTorch version.
"""

from __future__ import annotations

import threading
import uuid
from collections import OrderedDict

import numpy as np
import torch

from ..models.vgg import apply_decoder, apply_encoder
from ..models.zoo import load_pyramid
from ..ops.pad import reflect_index
from ..ops.wct_transform import feature_stats, wct_transform
from .slab import SlabCascade, _pad_rows, _to_u8, build_fused_slab_cascade

__all__ = ["WCTEngine", "stage_style_stats", "stylize_stage", "resolve_device",
           "STYLE_CACHE_MAX"]

# style-statistics cache bound: (stage, key, shape) -> (mean, cov) entries
# are small (C <= 512: <= 1 MB each), but a long-lived server registering
# styles forever must not grow device memory without bound.
STYLE_CACHE_MAX = 64


def resolve_device(device) -> torch.device:
    """``None`` means the GPU; asking for it without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "WCTEngine runs on the GPU unless asked otherwise, and CUDA is not "
            "available; pass device='cpu' for the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"WCTEngine runs on 'cuda' or 'cpu', got {dev}")
    return dev


def _pad_to_multiple(x: torch.Tensor, mult: int = 16) -> tuple[torch.Tensor, tuple[int, int]]:
    """Reflect-pad H and W to a multiple of ``mult``, bottom and right, as
    ``np.pad(mode="reflect")`` does."""
    _, h, w, _ = x.shape
    ph = (-h) % mult
    pw = (-w) % mult
    if ph:
        x = x.index_select(1, reflect_index(h, 0, ph, x.device))
    if pw:
        x = x.index_select(2, reflect_index(w, 0, pw, x.device))
    return x, (h, w)


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
    Images shorter than two margins take the plain path; a height that
    wastes more than a quarter slab in padding gets an evenly dividing slab
    (``SlabCascade.pick_slab_rows``). A uint8 output of at least
    ``stream_min_pix`` pixels leaves the fused path's last stage to the
    streamed tail (:meth:`SlabCascade.stream_last_stage`).
    """

    def __init__(self, mode: str = "16x", weights_root: str | None = None, *,
                 method: str = "eigh", newton_iters: int = 24,
                 stages=(5, 4, 3, 2, 1), pyramid=None, device=None,
                 slab_rows: int = 0, fused: bool = True,
                 stream_min_pix: int = 8 * 1024 * 1024):
        if method not in ("eigh", "newton"):
            raise ValueError(f"unknown WCT method {method!r}")
        self.device = resolve_device(device)
        self.mode = mode
        self.method = method
        self.newton_iters = newton_iters
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
        self.fused = bool(slab_rows) and fused
        self._fused_fns: dict = {}  # (slab_rows, tail_stats) -> fused cascade
        if slab_rows:
            self.slab = SlabCascade(self.pyramid, stages=self.stages,
                                    slab_rows=slab_rows, method=method,
                                    newton_iters=newton_iters)

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
        padded float32 NHWC batch on the engine's device."""
        x = torch.as_tensor(np.ascontiguousarray(image) if isinstance(image, np.ndarray)
                            else image).to(self.device)
        if x.dim() == 3:
            x = x[None]
        x = self._u8_to_float(x) if x.dtype == torch.uint8 else x.float()
        return _pad_to_multiple(x, 16)[0]

    @torch.inference_mode()
    def stylize(self, content: np.ndarray, style: np.ndarray, alpha: float = 1.0,
                *, num_run: int = 1, style_key=None, as_uint8: bool = False) -> np.ndarray:
        """Stylize one content/style pair (or a batch). Inputs: (H, W, 3) or
        (N, H, W, 3), float in [0, 1] or uint8 in [0, 255]; returns the same
        rank, clipped to [0, 1] (float) or rounded to uint8 (``as_uint8``).
        uint8 images cross the host link as 3 bytes per pixel and are
        converted on the device."""
        squeeze = np.ndim(content) == 3
        img = self._prep(content)
        h, w = np.shape(content)[-3:-1]
        out = self._run(img, self._prep(style), alpha, num_run=num_run,
                        style_key=style_key, as_uint8=as_uint8)[:, :h, :w]
        if not isinstance(out, np.ndarray):  # numpy: streamed to the host as uint8
            out = (_to_u8(out) if as_uint8 else torch.clamp(out, 0.0, 1.0)).cpu().numpy()
        return out[0] if squeeze else out

    @torch.inference_mode()
    def stylize_device(self, content: torch.Tensor, style: torch.Tensor,
                       alpha: float = 1.0, *, num_run: int = 1,
                       style_key=None) -> torch.Tensor:
        """Device-resident stylization: float (N, H, W, 3) or (H, W, 3)
        tensors in, a float (N, H, W, 3) tensor on the engine's device out,
        cropped to the input's H, W and clipped to [0, 1]; no host transfer."""
        h, w = content.shape[-3:-1]
        out = self._run(self._prep(content), self._prep(style), alpha,
                        num_run=num_run, style_key=style_key)
        return torch.clamp(out[:, :h, :w], 0.0, 1.0)

    def _fused_fn(self, slab: int, tail: bool):
        key = (slab, tail)
        if key not in self._fused_fns:
            self._fused_fns[key] = build_fused_slab_cascade(
                self.pyramid, stages=self.stages, slab_rows=slab, method=self.method,
                newton_iters=self.newton_iters, external_style_stats=True,
                tail_stats=tail)
        return self._fused_fns[key]

    def _run(self, img, sty, alpha, *, num_run: int, style_key, as_uint8: bool = False):
        """The cascade on padded device inputs: the (padded) device image, or
        a host uint8 numpy image where a slab path streamed it there."""
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=self.device)
        if self.slab is not None and (img.shape[0] > 1 or sty.shape[0] > 1):
            raise ValueError("the slab path is per-image (its statistics would pool "
                             "the batch); stylize the images one at a time")
        if self.slab is None or img.shape[1] < 2 * self.slab.margin:
            # no slabs, or an image smaller than one slab's margins
            return self._run_plain(img, sty, alpha, num_run=num_run, style_key=style_key)
        if not self.fused:
            for i in range(num_run):
                img = self.slab.stylize(img, sty, alpha,
                                        to_host_uint8=as_uint8 and i == num_run - 1)
            return img
        h = img.shape[1]
        slab = self.slab.slab_rows
        if -(-h // slab) * slab - h > slab // 4:
            # awkward height: an evenly dividing slab size
            slab = SlabCascade.pick_slab_rows(h, slab, self.slab.margin,
                                              self.slab.down_max)
        img = _pad_rows(img, -(-h // slab) * slab)
        sstats = self._fused_style_stats(sty, style_key)
        if as_uint8 and num_run == 1 and img.shape[1] * img.shape[2] >= self.stream_min_pix:
            head = self._fused_fn(slab, True)
            h_img, t, c_mean, s_mean, kept = head(img, sstats, alpha)
            return head.cascade.stream_last_stage(h_img, t, c_mean, s_mean, alpha, kept=kept)
        fn = self._fused_fn(slab, False)
        for _ in range(num_run):
            img = fn(img, sstats, alpha)
        return img

    def _run_plain(self, img, sty, alpha, *, num_run: int, style_key):
        for _ in range(num_run):
            for k in self.stages:
                s_mean, s_cov = self._style_stats(k, sty, cache_key=style_key)
                p = self.pyramid[k]
                img = stylize_stage(p["enc"], p["dec"], p["enc_spec"], p["dec_spec"],
                                    img, s_mean, s_cov, alpha, self.method,
                                    self.newton_iters)
        return img

    @staticmethod
    def _u8_to_float(x: torch.Tensor) -> torch.Tensor:
        return x.float() / 255.0
