"""Single-card ultra-resolution path: the cascade in shingled row slabs.

A 10240x4096 (42 MPix) image is streamed through each pyramid level in row
slabs, so the full-resolution feature maps of a level never exist at once:

* every slab is extended by its stage's ``margin`` rows on each side, at
  least the encoder+decoder receptive radius of that stage (144/64/32/16/16
  input rows for the ``16x`` pyramid), so the slab's interior rows equal the
  full-image computation;
* the WCT statistics are exact: pass 1 adds up per-slab sums and Grams over
  interior feature rows only, all shifted by one vector per stage (see
  :func:`..ops.wct_transform.feature_stats`), and the coloring matrix is
  built once per stage;
* pass 2 applies the whole WCT as one folded affine map (the ``conv1x1_bias``
  kernel), decodes, and writes the interior rows into one preallocated
  output. Edge slabs start and end at the image boundary, where the
  per-conv reflection is the full image's own.

:class:`SlabCascade` runs one stage at a time, re-encoding every slab in
pass 2 (the reference's per-stage programs); :func:`build_fused_slab_cascade`
is the production path: pass 1's features are kept where a stage's fit in
``feature_cache_bytes`` and pass 2 skips the re-encode, style statistics may
come precomputed, and the last stage's pass 2 may be left to
:meth:`SlabCascade.stream_last_stage`, which sends each slab to the host as
uint8 while the next one computes. Both share one stage loop,
:meth:`SlabCascade.run`. PyTorch runs eagerly, so nothing here is
compiled; the reference's fusion into one program has no counterpart beyond
what changes the work and the results.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.vgg import apply_decoder, apply_encoder
from ..ops.pad import reflect_index
from ..ops.wct_transform import (coloring_matrix, feature_stats, gram_shift,
                                 shifted_sum_gram, stats_from_sums,
                                 wct_apply_folded)
from ..utils.transfer import fetch_async

__all__ = ["receptive_radius", "SlabCascade", "build_fused_slab_cascade",
           "FEATURE_CACHE_BYTES"]

# pass 1 keeps a stage's stacked slab features when they take at most this
# many bytes (at UHD every 16x stage does; stage 1 is the largest, ~4.2 GB)
FEATURE_CACHE_BYTES = 6_500_000_000


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """The one float -> uint8 output conversion (round half up), shared by
    every output path so that streamed and monolithic results agree."""
    return (torch.clamp(x.float(), 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def _pad_rows(x: torch.Tensor, hp: int) -> torch.Tensor:
    """Reflect-pad the rows of an NHWC map at the bottom up to ``hp``."""
    h = x.shape[1]
    return x if hp == h else x.index_select(1, reflect_index(h, 0, hp - h, x.device))


def _encode(p, spec, x: torch.Tensor) -> torch.Tensor:
    return apply_encoder(p, x, spec, aux=False)["out"]


def receptive_radius(spec) -> int:
    """Receptive-field radius in input pixels of a stage spec (each 3x3 conv
    adds its current downsample factor; pools double it; decoder mirrors)."""
    r, d = 0, 1
    if spec.kind == "encoder":
        for layer in spec.layers:
            r += d
            if layer.pool_after:
                d *= 2
        return r
    # decoder: walk output->input (reversed spec order); a conv that is
    # followed by an unpool runs at the coarser scale, so double first.
    for layer in reversed(spec.layers):
        if layer.unpool_after:
            d *= 2
        r += d
    return r


class SlabCascade:
    """Streaming 5-level WCT cascade with memory bounded by the slab size.

    ``slab_rows`` interior rows per slab, rounded up to the deepest stage's
    downsample factor so that feature-scale slicing is integral; each stage's
    margin is its own enc+dec receptive radius, rounded the same way.
    """

    def __init__(self, pyramid, *, stages=(5, 4, 3, 2, 1), slab_rows: int = 1024,
                 method: str = "eigh", newton_iters: int = 24, eps: float = 1e-8):
        self.pyramid = pyramid
        self.stages = tuple(stages)
        self.method = method
        self.newton_iters = newton_iters
        self.eps = eps
        self.down_max = 2 ** (max(stages) - 1)
        self.margins = {
            k: -(-(receptive_radius(pyramid[k]["enc_spec"])
                   + receptive_radius(pyramid[k]["dec_spec"]))
                 // self.down_max) * self.down_max
            for k in self.stages}
        self.margin = max(self.margins.values())
        self.slab_rows = -(-slab_rows // self.down_max) * self.down_max

    @staticmethod
    def pick_slab_rows(h: int, target: int, margin: int, gran: int) -> int:
        """Slab size that divides the padded height as evenly as possible:
        largest slab <= target (multiple of ``gran``, >= 2*margin) minimizing
        the pad waste of rounding ``h`` up to a slab multiple."""
        floor_slab = max(2 * margin, gran)
        best, best_waste = None, None
        cand = floor_slab
        while cand <= max(target, floor_slab):
            waste = (-h) % cand
            if best is None or waste < best_waste or (waste == best_waste and cand > best):
                best, best_waste = cand, waste
            cand += gran
        return best

    def _slabs(self, h: int, stage: int | None = None):
        """Yield (input_start, input_rows, interior_offset) per slab.

        Edge slabs start/end at the true image boundary; mid slabs carry a
        margin on both sides; the last slab's interior starts ``2 * m`` into
        it. ``stage``: use that stage's own margin (None: the largest).
        """
        slab = self.slab_rows
        m = self.margins[stage] if stage is not None else self.margin
        n_slabs = h // slab
        if n_slabs == 1:
            yield 0, h, 0
            return
        assert slab >= 2 * m, (
            f"slab_rows ({slab}) must be >= 2*margin ({2 * m}) so edge slabs "
            f"share the mid-slab shape")
        for i in range(n_slabs):
            if i == 0:
                yield 0, slab + 2 * m, 0
            elif i == n_slabs - 1:
                yield h - slab - 2 * m, slab + 2 * m, 2 * m
            else:
                yield i * slab - m, slab + 2 * m, m

    def style_stats(self, k, style: torch.Tensor):
        """(mean, cov) of the whole style image's stage-``k`` features."""
        p = self.pyramid[k]
        return feature_stats(_encode(p["enc"], p["enc_spec"], style))

    def _color_decode(self, k, feats, t, c_mean, s_mean, alpha, offset: int,
                      interior: int) -> torch.Tensor:
        """Folded WCT + decoder on one slab's features; its interior rows."""
        p = self.pyramid[k]
        csf = wct_apply_folded(feats, t, c_mean, s_mean, alpha)
        dec = apply_decoder(p["dec"], csf, p["dec_spec"])["out"]
        return dec[:, offset:offset + interior]

    def slab_sums(self, k, img: torch.Tensor, slabs, *, shift=None, keep: bool = False):
        """Pass 1 of stage ``k`` over ``slabs``, ``(start, rows, offset)``
        triples into the rows of ``img`` (1, H, W, 3): ``(shift, sum, gram,
        count, kept)``, the shifted sum and Gram of every slab's interior
        feature rows added up, their pixel count, and with ``keep`` the list
        of the slabs' features (else None). ``shift`` is the Gram's shift;
        None takes the mean of the first slab's first interior rows. Sums of
        several calls add only where they used one shift."""
        if img.shape[0] != 1:
            raise ValueError("the slab path is per-image (N = 1): WCT statistics "
                             "would pool the batch")
        p = self.pyramid[k]
        spec = p["enc_spec"]
        down = 2 ** (k - 1)
        interior_f = self.slab_rows // down
        c = spec.out_channels
        kept, s_sum, g_sum, count = [], 0.0, 0.0, 0
        for start, rows, off in slabs:
            feats = _encode(p["enc"], spec, img[:, start:start + rows])
            x = feats[:, off // down:off // down + interior_f].reshape(-1, c)
            if shift is None:
                shift = gram_shift(x)
            s, g = shifted_sum_gram(x, shift)
            s_sum, g_sum, count = s_sum + s, g_sum + g, count + x.shape[0]
            if keep:
                kept.append(feats)
            del feats, x
        return shift, s_sum, g_sum, count, kept if keep else None

    def content_stats(self, k, img: torch.Tensor, *, keep: bool = False):
        """Pass 1 of stage ``k`` over ``img`` (1, H, W, 3), H a multiple of
        ``slab_rows``: ``(mean, cov, kept)``, the exact statistics of the
        interior feature rows of every slab, all shifted by the mean of the
        first slab's first interior rows, and with ``keep`` the list of the
        slabs' features (else None)."""
        shift, s_sum, g_sum, count, kept = self.slab_sums(
            k, img, self._slabs(img.shape[1], k), keep=keep)
        mean, cov = stats_from_sums(shift, s_sum, g_sum, count)
        return mean, cov, kept

    def feature_bytes(self, k, h: int, w: int) -> int:
        """Bytes of stage ``k``'s stacked slab features for an (h, w) image."""
        down = 2 ** (k - 1)
        slabs = list(self._slabs(h, k))
        return (len(slabs) * (slabs[0][1] // down) * (w // down)
                * self.pyramid[k]["enc_spec"].out_channels * 4)

    def run(self, img: torch.Tensor, stats_of, alpha, *, feature_cache_bytes: int = 0,
            tail: bool = False):
        """The cascade over ``img`` (1, H, W, 3), H a multiple of
        ``slab_rows``; ``stats_of(k)`` gives stage ``k``'s style ``(mean,
        cov)``. Per stage: pass 1, keeping the slabs' features when they fit
        in ``feature_cache_bytes``; the coloring matrix; pass 2. With
        ``tail``, stop before the last stage's pass 2 and return ``(img, t,
        c_mean, s_mean, kept)`` for :meth:`stream_last_stage`."""
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=img.device)
        for k in self.stages:
            s_mean, s_cov = stats_of(k)
            keep = self.feature_bytes(k, *img.shape[1:3]) <= feature_cache_bytes
            c_mean, c_cov, kept = self.content_stats(k, img, keep=keep)
            t = coloring_matrix(c_cov, s_cov.float(), method=self.method, eps=self.eps,
                                newton_iters=self.newton_iters)
            if tail and k == self.stages[-1]:
                return img, t, c_mean, s_mean, kept
            img = self.color_decode_stage(k, img, t, c_mean, s_mean, alpha, kept=kept)
        return img

    def _decoded_slabs(self, k, img: torch.Tensor, t, c_mean, s_mean, alpha, kept,
                       slabs=None):
        """Pass 2 of stage ``k``: yields ``(row, rows)``, each slab's
        interior rows, decoded from its features (``kept[i]``, which is
        released, or encoded anew) through the folded WCT. ``slabs``:
        ``(start, rows, offset)`` triples into ``img``'s rows instead of
        :meth:`_slabs`'s (a row shard extended by its neighbours' halos)."""
        p = self.pyramid[k]
        slab = self.slab_rows
        if slabs is None:
            slabs = self._slabs(img.shape[1], k)
        for i, (start, rows, off) in enumerate(slabs):
            if kept is not None:
                feats, kept[i] = kept[i], None
            else:
                feats = _encode(p["enc"], p["enc_spec"], img[:, start:start + rows])
            yield i * slab, self._color_decode(k, feats, t, c_mean, s_mean, alpha, off, slab)
            del feats

    def color_decode_stage(self, k, img: torch.Tensor, t, c_mean, s_mean, alpha, *,
                           kept=None, slabs=None) -> torch.Tensor:
        """Pass 2 of stage ``k``, interior rows into one preallocated image
        of ``slab_rows`` rows per slab (``img``'s own height without
        ``slabs``)."""
        slabs = list(self._slabs(img.shape[1], k) if slabs is None else slabs)
        out = img.new_empty((img.shape[0], len(slabs) * self.slab_rows, *img.shape[2:]))
        for row, rows in self._decoded_slabs(k, img, t, c_mean, s_mean, alpha, kept, slabs):
            out[:, row:row + rows.shape[1]] = rows
        return out

    def stylize(self, content: torch.Tensor, style: torch.Tensor, alpha=1.0, *,
                to_host_uint8: bool = False):
        """content (1, H, W, 3); style (1, Hs, Ws, 3), encoded whole at every
        stage. H is reflect-padded to a slab multiple and cropped back.

        ``to_host_uint8``: send the last stage's slabs to the host as uint8
        while later slabs compute; returns a numpy (1, H, W, 3) uint8 array.
        """
        n, h = content.shape[:2]
        if n != 1:
            raise ValueError("the slab path is per-image (N = 1)")
        img = _pad_rows(content, -(-h // self.slab_rows) * self.slab_rows)
        out = self.run(img, lambda k: self.style_stats(k, style), alpha,
                       tail=to_host_uint8)
        if to_host_uint8:
            img, t, c_mean, s_mean, kept = out
            out = self.stream_last_stage(img, t, c_mean, s_mean, alpha, kept=kept)
        return out[:, :h]

    def stream_last_stage(self, img: torch.Tensor, t, c_mean, s_mean, alpha, *,
                          kept=None, emit: str = "u8") -> np.ndarray:
        """Pass 2 of the cascade's LAST stage, each slab's rows sent to the
        host as uint8 while the next slab computes.

        ``img``: (1, H, W, 3), the image entering the last stage; ``t,
        c_mean, s_mean, kept``: that stage's pass-1 results (the ``tail``
        return of :meth:`run`; without ``kept`` each slab is encoded anew).
        On the card each slab's rows are copied on a side stream into one of
        two pinned staging buffers, and from there into the (pageable)
        result while the card decodes the next slab. Returns host uint8 (1,
        H, W, 3). Only ``emit="u8"``: YCbCr planes come with the
        host-boundary port.
        """
        if emit != "u8":
            raise ValueError(f"emit={emit!r}: only 'u8' is ported (YCbCr 4:2:0 "
                             f"planes wait for utils/colorspace.py)")
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=img.device)
        out = np.empty((*img.shape[:3], 3), np.uint8)
        bands = self._decoded_slabs(self.stages[-1], img, t, c_mean, s_mean, alpha, kept)
        if img.device.type != "cuda":
            for row, rows in bands:
                out[:, row:row + rows.shape[1]] = _to_u8(rows).numpy()
            return out
        side = torch.cuda.Stream(img.device)
        staging = [torch.empty((1, self.slab_rows, img.shape[2], 3), dtype=torch.uint8,
                               pin_memory=True) for _ in range(2)]
        pending = None
        for i, (row, rows) in enumerate(bands):
            # staging[i % 2] was drained (host side) one slab ago
            done = fetch_async(_to_u8(rows), staging[i % 2], side)
            if pending is not None:
                _drain(out, *pending)
            pending = row, staging[i % 2], done
        _drain(out, *pending)
        return out


def _drain(out: np.ndarray, row: int, buf: torch.Tensor, done) -> None:
    """Wait for a slab's copy into the pinned ``buf``; move it into ``out``."""
    done.synchronize()
    out[:, row:row + buf.shape[1]] = buf.numpy()


def build_fused_slab_cascade(pyramid, *, stages=(5, 4, 3, 2, 1), slab_rows: int = 1024,
                             method: str = "eigh", newton_iters: int = 24,
                             eps: float = 1e-8,
                             feature_cache_bytes: int = FEATURE_CACHE_BYTES,
                             external_style_stats: bool = False,
                             tail_stats: bool = False):
    """The production slab cascade: ``fn(img, style, alpha) -> img``.

    ``img`` is (1, H, W, 3) with H a positive multiple of ``slab_rows``
    (rounded as :class:`SlabCascade` rounds it; ``fn.cascade`` is that
    helper). Stages whose stacked slab features fit in
    ``feature_cache_bytes`` keep pass 1's features and skip pass 2's
    re-encode.

    ``external_style_stats``: ``style`` is ``{stage: (mean, cov)}``,
    precomputed (the engine caches them per style key) instead of the style
    image.

    ``tail_stats``: stop before the LAST stage's pass 2 and return ``(img,
    t, c_mean, s_mean, kept)``, the image entering that stage and its pass-1
    results, for :meth:`SlabCascade.stream_last_stage`.
    """
    helper = SlabCascade(pyramid, stages=stages, slab_rows=slab_rows, method=method,
                         newton_iters=newton_iters, eps=eps)
    slab = helper.slab_rows

    def fn(img, style, alpha):
        h = img.shape[1]
        if h < slab or h % slab:
            raise ValueError(
                f"image height {h} must be a positive multiple of slab_rows="
                f"{slab}; pad the image or pick a smaller slab "
                f"(WCTEngine.stylize does both)")
        stats_of = (style.__getitem__ if external_style_stats
                    else lambda k: helper.style_stats(k, style))
        return helper.run(img, stats_of, alpha, feature_cache_bytes=feature_cache_bytes,
                          tail=tail_stats)

    fn.cascade = helper
    return fn
