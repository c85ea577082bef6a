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
  per-conv reflection is the full image's own;
* the windows cover the image's own rows and nothing past them: a last slab
  shorter than ``slab_rows`` is a full-size window shifted up to end at the
  image's last row, of which only the new rows count. No row is padded in
  by mirroring, so the statistics are the plain cascade's (the reference
  pads the height to a slab multiple with mirrored rows and sums them).

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

``packed=True`` folds each encoder's ``conv0`` into its ``conv1_1``
(:func:`..models.packed_vgg.pack_stage_params`), as the reference's packed
slab paths do; the style statistics then come from the folded encoders too.
The reference's width layout has no counterpart.

The content's WCT opens ``cd.wct`` spans (:func:`..utils.profiling.span`):
each window's shifted sum and Gram, a stage's statistics and coloring
matrix, each window's folded apply; a style's statistics taken here open
``cd.style``.

A bfloat16 pyramid and image run in bf16: bf16 slabs and feature cache (half
the bytes), the folded WCT in bf16 (``M`` bf16, ``beta`` float32); the sums
and Grams of pass 1 are taken in float32 over a float32 copy of each slab's
interior features, and the uint8 tail converts from float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.packed_vgg import pack_stage_params
from ..models.vgg import apply_decoder, apply_encoder
from ..ops.pad import reflect_index
from ..ops.wct_transform import (coloring_matrix, feature_stats, gram_shift,
                                 shifted_sum_gram, stats_from_sums,
                                 wct_apply_folded)
from ..utils.colorspace import rgbf_to_yuv420_device, yuv420_to_rgb_host
from ..utils.profiling import span
from ..utils.transfer import fetch_async, pinned_empty

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

    ``packed``: run the encoders with ``conv0`` folded into ``conv1_1``, the
    trees ``packed_params`` (``{stage: {"enc", "dec"}}``, folded once and
    shared by the cascades over one set of weights) or folded here.
    """

    def __init__(self, pyramid, *, stages=(5, 4, 3, 2, 1), slab_rows: int = 1024,
                 method: str = "eigh", newton_iters: int = 24, eps: float = 1e-8,
                 packed: bool = False, packed_params=None):
        self.pyramid = pyramid
        self.stages = tuple(stages)
        self.packed = packed
        self.packed_params = None
        if packed:
            self.packed_params = packed_params if packed_params is not None else {
                k: {"enc": pack_stage_params(pyramid[k]["enc"], pyramid[k]["enc_spec"]),
                    "dec": pack_stage_params(pyramid[k]["dec"], pyramid[k]["dec_spec"])}
                for k in self.stages}
        # the trees the slabs run (a pyramid of specs alone plans slabs)
        self.params = self.packed_params if packed else {
            k: {"enc": pyramid[k].get("enc"), "dec": pyramid[k].get("dec")}
            for k in self.stages}
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
        """Yield (input_start, input_rows, interior_offset, interior_rows)
        per window over the rows [0, h) of the image, and nothing past them.

        Window i holds the image rows [i * slab, min((i + 1) * slab, h)) as
        its interior. Every window takes ``slab + 2m`` rows: the first starts
        at the image's top, the others a margin above their interior, and a
        window that would end past ``h`` is shifted up to end at ``h``, its
        interior offset moved so that only its own rows count. A window that
        starts or ends at the image boundary has the full image's per-conv
        reflection there; an image of fewer than ``slab + 2m`` rows is one
        window. ``stage``: that stage's own margin (None: the largest).
        """
        slab = self.slab_rows
        m = self.margins[stage] if stage is not None else self.margin
        rows = slab + 2 * m
        if h < rows:
            yield 0, h, 0, h
            return
        assert slab >= 2 * m, (
            f"slab_rows ({slab}) must be >= 2*margin ({2 * m}) so edge slabs "
            f"share the mid-slab shape")
        for row in range(0, h, slab):
            start = min(max(row - m, 0), h - rows)
            yield start, rows, row - start, min(slab, h - row)

    def style_stats(self, k, style: torch.Tensor):
        """(mean, cov) of the whole style image's stage-``k`` features, from
        the cascade's own (folded, with ``packed``) encoder."""
        return feature_stats(_encode(self.params[k]["enc"], self.pyramid[k]["enc_spec"], style))

    def _style_stats_of(self, style: torch.Tensor):
        """``stats_of`` for :meth:`run` over the style image: each stage's
        :meth:`style_stats` in a ``cd.style`` span."""
        def stats_of(k):
            with span("cd.style"):
                return self.style_stats(k, style)
        return stats_of

    def _color_decode(self, k, feats, t, c_mean, s_mean, alpha, offset: int,
                      interior: int) -> torch.Tensor:
        """Folded WCT + decoder on one slab's features; its interior rows."""
        with span("cd.wct"):
            csf = wct_apply_folded(feats, t, c_mean, s_mean, alpha)
        dec = apply_decoder(self.params[k]["dec"], csf, self.pyramid[k]["dec_spec"],
                            taps=False)["out"]
        return dec[:, offset:offset + interior]

    def slab_sums(self, k, img: torch.Tensor, slabs, *, shift=None, keep: bool = False):
        """Pass 1 of stage ``k`` over ``slabs``, ``(start, rows, offset,
        interior)`` windows into the rows of ``img`` (1, H, W, 3): ``(shift,
        sum, gram, count, kept)``, the shifted sum and Gram of every window's
        interior feature rows added up, their pixel count, and with ``keep``
        the list of the windows' features (else None). ``shift`` is the
        Gram's shift; None takes the mean of the first window's first
        interior rows. Sums of several calls add only where they used one
        shift."""
        if img.shape[0] != 1:
            raise ValueError("the slab path is per-image (N = 1): WCT statistics "
                             "would pool the batch")
        enc, spec = self.params[k]["enc"], self.pyramid[k]["enc_spec"]
        down = 2 ** (k - 1)
        c = spec.out_channels
        kept, s_sum, g_sum, count = [], 0.0, 0.0, 0
        for start, rows, off, n in slabs:
            feats = _encode(enc, spec, img[:, start:start + rows])
            with span("cd.wct"):
                x = feats[:, off // down:(off + n) // down].reshape(-1, c).float()
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
        the pyramid's granularity: ``(mean, cov, kept)``, the exact
        statistics of the image's feature rows (each window's interior rows
        once), all shifted by the mean of the first window's first interior
        rows, and with ``keep`` the list of the windows' features (else
        None)."""
        shift, s_sum, g_sum, count, kept = self.slab_sums(
            k, img, self._slabs(img.shape[1], k), keep=keep)
        with span("cd.wct"):
            mean, cov = stats_from_sums(shift, s_sum, g_sum, count)
        return mean, cov, kept

    def feature_bytes(self, k, h: int, w: int, itemsize: int = 4) -> int:
        """Bytes of stage ``k``'s stacked slab features for an (h, w) image,
        ``itemsize`` bytes an element (2 in bfloat16)."""
        down = 2 ** (k - 1)
        return (sum(rows // down for _, rows, _, _ in self._slabs(h, k)) * (w // down)
                * self.pyramid[k]["enc_spec"].out_channels * itemsize)

    def run(self, img: torch.Tensor, stats_of, alpha, *, feature_cache_bytes: int = 0,
            tail: bool = False):
        """The cascade over ``img`` (1, H, W, 3), H a multiple of the
        pyramid's granularity; ``stats_of(k)`` gives stage ``k``'s style
        ``(mean, cov)``. Per stage: pass 1, keeping the slabs' features when they fit
        in ``feature_cache_bytes``; the coloring matrix; pass 2. With
        ``tail``, stop before the last stage's pass 2 and return ``(img, t,
        c_mean, s_mean, kept)`` for :meth:`stream_last_stage`."""
        for k in self.stages:
            s_mean, s_cov = stats_of(k)
            keep = (self.feature_bytes(k, *img.shape[1:3], img.element_size())
                    <= feature_cache_bytes)
            c_mean, c_cov, kept = self.content_stats(k, img, keep=keep)
            with span("cd.wct"):
                t = coloring_matrix(c_cov, s_cov.float(), method=self.method, eps=self.eps,
                                    newton_iters=self.newton_iters)
            if tail and k == self.stages[-1]:
                return img, t, c_mean, s_mean, kept
            img = self.color_decode_stage(k, img, t, c_mean, s_mean, alpha, kept=kept)
        return img

    def _decoded_slabs(self, k, img: torch.Tensor, t, c_mean, s_mean, alpha, kept,
                       slabs=None):
        """Pass 2 of stage ``k``: yields ``(row, rows)``, each window's
        interior rows and where they go in the output, decoded from its
        features (``kept[i]``, which is released, or encoded anew) through
        the folded WCT. ``slabs``: ``(start, rows, offset, interior)``
        windows into ``img``'s rows instead of :meth:`_slabs`'s (a row shard
        extended by its neighbours' halos)."""
        enc, spec = self.params[k]["enc"], self.pyramid[k]["enc_spec"]
        if slabs is None:
            slabs = self._slabs(img.shape[1], k)
        row = 0
        for i, (start, rows, off, n) in enumerate(slabs):
            if kept is not None:
                feats, kept[i] = kept[i], None
            else:
                feats = _encode(enc, spec, img[:, start:start + rows])
            yield row, self._color_decode(k, feats, t, c_mean, s_mean, alpha, off, n)
            row += n
            del feats

    def color_decode_stage(self, k, img: torch.Tensor, t, c_mean, s_mean, alpha, *,
                           kept=None, slabs=None, out=None) -> torch.Tensor:
        """Pass 2 of stage ``k``, the windows' interior rows into one
        preallocated image (``img``'s own height without ``slabs``), or into
        ``out``, a map of that shape, type and device that may be a view
        (the interior of the next stage's extended row shard); returns it."""
        slabs = list(self._slabs(img.shape[1], k) if slabs is None else slabs)
        shape = (img.shape[0], sum(n for *_, n in slabs), *img.shape[2:])
        if out is None:
            out = img.new_empty(shape)
        elif (tuple(out.shape), out.dtype, out.device) != (shape, img.dtype, img.device):
            raise ValueError(f"color_decode_stage: out is {tuple(out.shape)} {out.dtype} on "
                             f"{out.device}, the stage writes {shape} {img.dtype} on "
                             f"{img.device}")
        for row, rows in self._decoded_slabs(k, img, t, c_mean, s_mean, alpha, kept, slabs):
            out[:, row:row + rows.shape[1]] = rows
        return out

    def stylize(self, content: torch.Tensor, style: torch.Tensor, alpha=1.0, *,
                to_host_uint8: bool = False):
        """content (1, H, W, 3); style (1, Hs, Ws, 3), encoded whole at every
        stage. H is reflect-padded to the pyramid's granularity, as the plain
        engine pads it, and cropped back.

        ``to_host_uint8``: send the last stage's slabs to the host as uint8
        while later slabs compute; returns a numpy (1, H, W, 3) uint8 array.
        """
        n, h = content.shape[:2]
        if n != 1:
            raise ValueError("the slab path is per-image (N = 1)")
        img = _pad_rows(content, -(-h // self.down_max) * self.down_max)
        out = self.run(img, self._style_stats_of(style), alpha, tail=to_host_uint8)
        if to_host_uint8:
            img, t, c_mean, s_mean, kept = out
            out = self.stream_last_stage(img, t, c_mean, s_mean, alpha, kept=kept)
        return out[:, :h]

    def stream_last_stage(self, img: torch.Tensor, t, c_mean, s_mean, alpha, *,
                          kept=None, emit: str = "u8", on_band=None):
        """Pass 2 of the cascade's LAST stage, each window's rows sent to
        the host while the next window computes.

        ``img``: (1, H, W, 3), the image entering the last stage; ``t,
        c_mean, s_mean, kept``: that stage's pass-1 results (the ``tail``
        return of :meth:`run`; without ``kept`` each window is encoded
        anew). The bands are the cascade's own windows (:meth:`_slabs`).
        ``emit``: ``"u8"`` returns host uint8 RGB (1, H, W, 3);
        ``"yuv420"`` converts each band to YCbCr 4:2:0 planes on the device
        (half the bytes), fetches them and reassembles RGB on the host, the
        same uint8 RGB result (it falls back to ``"u8"`` where a band or the
        width is odd); ``"planes"`` returns the host planes ``(Y (1, H, W),
        CbCr (1, H/2, W/2, 2))`` for JPEG-native serving.

        ``on_band``: called with each band's host result in order (for
        ``"planes"`` its ``(y, cbcr)``) while later bands compute; nothing
        is assembled and the call returns None. On the card each band is
        copied on a side stream into one of two pinned staging buffers
        while the card decodes the next one (:func:`..utils.transfer.pinned_empty`).
        """
        if emit not in ("u8", "yuv420", "planes"):
            raise ValueError(f"emit must be 'u8', 'yuv420' or 'planes', got {emit!r}")
        k = self.stages[-1]
        n, h, w, _ = img.shape
        windows = list(self._slabs(h, k))
        even = w % 2 == 0 and all(rows % 2 == 0 for *_, rows in windows)
        if not even and emit == "planes":
            raise ValueError(f"emit='planes' needs an even width and even window rows "
                             f"(W = {w}, windows {[r for *_, r in windows]})")
        if not even:
            emit = "u8"
        planes = emit != "u8"
        if on_band is not None:
            out = None
        elif emit == "planes":
            out = (np.empty((n, h, w), np.uint8), np.empty((n, h // 2, w // 2, 2), np.uint8))
        else:
            out = np.empty((n, h, w, 3), np.uint8)

        def deliver(row, parts):
            """One band's host arrays (staging views on the card) into the result."""
            if emit == "yuv420":
                parts = (yuv420_to_rgb_host(*parts),)
            if on_band is not None:
                res = tuple(p.copy() for p in parts) if emit == "planes" else parts[0].copy()
                on_band(res)
            elif emit == "planes":
                out[0][:, row:row + parts[0].shape[1]] = parts[0]
                out[1][:, row // 2:row // 2 + parts[1].shape[1]] = parts[1]
            else:
                out[:, row:row + parts[0].shape[1]] = parts[0]

        bands = ((row, rgbf_to_yuv420_device(rows) if planes else (_to_u8(rows),))
                 for row, rows in self._decoded_slabs(k, img, t, c_mean, s_mean, alpha, kept,
                                                      windows))
        if img.device.type != "cuda":
            for row, parts in bands:
                deliver(row, [p.numpy() for p in parts])
            return out
        side = torch.cuda.Stream(img.device)
        most = max(rows for *_, rows in windows)
        shapes = ([(n, most, w), (n, most // 2, w // 2, 2)] if planes else [(n, most, w, 3)])
        staging = [[pinned_empty(s, torch.uint8) for s in shapes] for _ in range(2)]
        pending = None
        for i, (row, parts) in enumerate(bands):
            # staging[i % 2] was drained (host side) one band ago
            bufs = [b[:, :p.shape[1]] for b, p in zip(staging[i % 2], parts)]
            for p, b in zip(parts, bufs):
                done = fetch_async(p, b, side)   # one side stream: the last event covers all
            if pending is not None:
                pending[2].synchronize()
                deliver(pending[0], [b.numpy() for b in pending[1]])
            pending = row, bufs, done
        pending[2].synchronize()
        deliver(pending[0], [b.numpy() for b in pending[1]])
        return out


def build_fused_slab_cascade(pyramid, *, stages=(5, 4, 3, 2, 1), slab_rows: int = 1024,
                             method: str = "eigh", newton_iters: int = 24,
                             eps: float = 1e-8, packed: bool = False,
                             feature_cache_bytes: int = FEATURE_CACHE_BYTES,
                             external_style_stats: bool = False,
                             tail_stats: bool = False, params=None):
    """The production slab cascade: ``fn(img, style, alpha) -> img``.

    ``img`` is (1, H, W, 3) with H a multiple of the pyramid's granularity
    (``fn.cascade``, the :class:`SlabCascade` helper, has it as
    ``down_max``; the windows end at H, see :meth:`SlabCascade._slabs`).
    Stages whose stacked slab features fit in ``feature_cache_bytes`` keep
    pass 1's features and skip pass 2's re-encode.

    ``external_style_stats``: ``style`` is ``{stage: (mean, cov)}``,
    precomputed (the engine caches them per style key) instead of the style
    image.

    ``tail_stats``: stop before the LAST stage's pass 2 and return ``(img,
    t, c_mean, s_mean, kept)``, the image entering that stage and its pass-1
    results, for :meth:`SlabCascade.stream_last_stage`.

    ``packed``: the encoders with ``conv0`` folded into ``conv1_1``;
    ``params`` shares a folded tree (:attr:`SlabCascade.packed_params`)
    instead of folding anew.
    """
    helper = SlabCascade(pyramid, stages=stages, slab_rows=slab_rows, method=method,
                         newton_iters=newton_iters, eps=eps, packed=packed,
                         packed_params=params if packed else None)

    def fn(img, style, alpha):
        h = img.shape[1]
        if h < 1 or h % helper.down_max:
            raise ValueError(
                f"image height {h} must be a positive multiple of the pyramid's "
                f"granularity {helper.down_max}; pad the image (WCTEngine.stylize "
                f"pads to 16)")
        stats_of = (style.__getitem__ if external_style_stats
                    else helper._style_stats_of(style))
        return helper.run(img, stats_of, alpha, feature_cache_bytes=feature_cache_bytes,
                          tail=tail_stats)

    fn.cascade = helper
    return fn
