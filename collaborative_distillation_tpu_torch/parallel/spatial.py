"""Spatially-tiled inference: the image's rows sharded over a device mesh.

One process drives all shards, so every function here takes and returns
**one tensor per shard**, in ``space`` order, each on its shard's device
(the reference writes the same functions per shard under ``shard_map``; the
lists take the place of its ``axis_name``). Two paths:

* per-conv halos (:func:`build_tiled_stylize_fn`): every reflect-pad 3x3 conv
  takes one-row halos from its mesh neighbours; at the two *global* edges
  the halo is the reference's reflection row, so tiled == untiled up to
  float32 reassociation. 2x2 pools and nearest upsamples are shard-local
  (local H stays even because the global H is padded to a multiple of
  16 * n_shards). The WCT statistics are shard-local sums added up over the
  mesh (a covariance is a sum over pixels, so the tiling is exact) and one
  coloring matrix is built and copied to every shard;
* slabs inside shards (:func:`build_tiled_slab_cascade`): per stage each
  shard takes ``2 * margin`` rows from each neighbour once, then streams
  through the stage in row slabs on its own, so its peak memory is bounded
  by the slab size whatever the image's height.

Both exchanges go through one kernel, ``halo_exchange_rows``
(:mod:`..ops.cuda.halo`): CUDA shards launch it, CPU shards take its plain
version. Nothing here assumes distinct devices: a mesh may name one card, or
the CPU, for every shard.
"""

from __future__ import annotations

import torch

from ..models.specs import StageSpec
from ..ops.conv import conv1x1, conv3x3, max_pool_2x2, on_card, upsample_nearest_2x
from ..ops.cuda import halo as _khalo
from ..ops.wct_transform import (coloring_matrix, gram_shift, shifted_sum_gram,
                                 stats_from_sums, wct_apply_folded)
from ..wct.slab import SlabCascade
from .mesh import Mesh

__all__ = [
    "halo_exchange_rows",
    "conv3x3_halo",
    "apply_encoder_spatial",
    "apply_decoder_spatial",
    "feature_stats_psum",
    "wct_transform_spatial",
    "build_tiled_stylize_fn",
    "slab_coords",
    "build_tiled_slab_cascade",
]


def _extend(x: torch.Tensor, top, bot, hm: int) -> torch.Tensor:
    """The one dispatcher of both exchanges: the kernel for a CUDA shard, its
    plain version for a CPU shard, nothing else."""
    if on_card(x):
        return _khalo.halo_exchange_rows(x, top, bot, hm)
    return _khalo.halo_exchange_rows_plain(x, top, bot, hm)


def _to(tree, device):
    """A parameter tree (or a tensor) on ``device``; what lies there already
    is not copied."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return {k: _to(v, device) for k, v in tree.items()}


def _alpha_on(alpha, device) -> torch.Tensor:
    return torch.as_tensor(alpha, dtype=torch.float32, device=device)


def _per_device(tree, devices):
    """One copy of ``tree`` per distinct device, listed once per shard."""
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = _to(tree, d)
    return [copies[d] for d in devices]


# ---- per-conv halos ----------------------------------------------------------

def halo_exchange_rows(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each shard (N, H, W, C) extended by one row above and below:
    (N, H + 2, W, C), the neighbours' boundary rows at shard borders and the
    reference's ReflectionPad2d row at the two global edges (row 1 at the
    top, row H-2 at the bottom). The reference returns the two halo rows
    (``ext[:, :1]``, ``ext[:, -1:]`` here); the kernel writes them and the
    shard into one map, which is what the conv reads."""
    n = len(xs)
    out = []
    for d, x in enumerate(xs):
        top = xs[d - 1][:, -1:] if d > 0 else None
        bot = xs[d + 1][:, :1] if d < n - 1 else None
        if x.shape[1] >= 2:
            edge_top, edge_bot = x[:, 1:2], x[:, -2:-1]
        else:
            # single-row shards (deep pyramid levels): the global reflect row
            # is the *opposite-direction* halo: for the top shard, global
            # row 1 lives on shard 1 and is its bottom halo (and vice versa);
            # a single shard of one row reflects onto itself
            edge_top, edge_bot = (x if bot is None else bot), (x if top is None else top)
        out.append(_extend(x, edge_top if top is None else top,
                           edge_bot if bot is None else bot, 1))
    return out


def conv3x3_halo(xs, ws, bs, *, relu: bool = True) -> list[torch.Tensor]:
    """Reflect-pad 3x3 conv whose H padding comes from the neighbours' halos;
    ``ws``, ``bs``: the layer's weight and bias on each shard's device.

    The conv runs on the H + 2 rows of the extended shard and the first and
    last output rows are dropped: rows 1..H of the output read only rows
    0..H+1 of the extended map, so the conv's own H reflection touches only
    the rows dropped, and its W reflection is the full image's."""
    return [conv3x3(e, w, b, relu=relu)[:, 1:-1].contiguous()
            for e, w, b in zip(halo_exchange_rows(xs), ws, bs)]


def _layer(params, name: str, kind: str):
    return [p[name][kind] for p in params]


def apply_encoder_spatial(params, xs, spec: StageSpec, *, aux_relu: bool = False):
    """Row-sharded mirror of :func:`..models.vgg.apply_encoder`: ``params``
    is the stage's parameter tree per shard, each named feature a list of
    shards."""
    if spec.kind != "encoder":
        raise ValueError(f"apply_encoder_spatial needs an encoder spec, got {spec.kind!r}")
    outs = {}
    if spec.has_conv0:
        xs = [conv1x1(x, p["conv0"]["w"], p["conv0"]["b"]) for x, p in zip(xs, params)]
    for layer in spec.layers:
        xs = conv3x3_halo(xs, _layer(params, layer.name, "w"),
                          _layer(params, layer.name, "b"), relu=layer.relu)
        if layer.tap:
            outs[layer.tap] = xs
        if layer.pool_after:
            xs = [max_pool_2x2(x) for x in xs]  # local: H_loc is even by construction
    outs["out"] = xs
    for layer in spec.aux:
        src = outs[f"relu{layer.name[4]}1"]
        outs[layer.tap] = [conv1x1(x, p[layer.name]["w"], p[layer.name]["b"], relu=aux_relu)
                           for x, p in zip(src, params)]
    return outs


def apply_decoder_spatial(params, xs, spec: StageSpec) -> list[torch.Tensor]:
    """Row-sharded mirror of :func:`..models.vgg.apply_decoder`."""
    if spec.kind != "decoder":
        raise ValueError(f"apply_decoder_spatial needs a decoder spec, got {spec.kind!r}")
    for layer in spec.layers:
        xs = conv3x3_halo(xs, _layer(params, layer.name, "w"),
                          _layer(params, layer.name, "b"), relu=layer.relu)
        if layer.unpool_after:
            xs = [upsample_nearest_2x(x) for x in xs]
    return xs


def feature_stats_psum(feats: list[torch.Tensor]):
    """Exact global (mean, cov) from row-shard-local partial sums, on the
    first shard's device.

    Every shard's sum and Gram (the ``sum_gram`` kernel) are shifted by one
    vector, the mean of the first shard's first rows, copied to each device;
    sums taken with different shifts would not add. The reference's
    ``global_pixels`` is the sum of the shards' own counts here."""
    c = feats[0].shape[-1]
    dev = feats[0].device
    shift, s_sum, g_sum, count = None, 0.0, 0.0, 0
    for f in feats:
        x = f.reshape(-1, c).float().contiguous()
        if shift is None:
            shift = gram_shift(x)
        s, g = shifted_sum_gram(x, shift.to(x.device))
        s_sum, g_sum, count = s_sum + s.to(dev), g_sum + g.to(dev), count + x.shape[0]
    return stats_from_sums(shift, s_sum, g_sum, count)


def wct_transform_spatial(content_feats, style_mean, style_cov, alpha, *,
                          method: str = "eigh", eps: float = 1e-8,
                          newton_iters: int = 24) -> list[torch.Tensor]:
    """Shard-local WCT application with globally exact content statistics:
    one coloring matrix, built on the first shard's device and copied, so
    that no two shards colour with matrices that differ in the last bit."""
    dev = content_feats[0].device
    c_mean, c_cov = feature_stats_psum(content_feats)
    t = coloring_matrix(c_cov, style_cov.float().to(dev), method=method, eps=eps,
                        newton_iters=newton_iters)
    return [wct_apply_folded(f, t.to(f.device), c_mean.to(f.device),
                             style_mean.to(f.device), _alpha_on(alpha, f.device))
            for f in content_feats]


def build_tiled_stylize_fn(pyramid, mesh: Mesh, *, stages=(5, 4, 3, 2, 1),
                           method: str = "eigh", newton_iters: int = 24):
    """Row-sharded full cascade over ``mesh``'s ``space`` axis.

    Returns ``f(content, style, alpha)``; content and style are lists of
    (N, H_loc, W, 3) row shards, one per ``space`` device and on it, with
    H_loc divisible by the deepest stage's downsample factor (pad the global
    H to a multiple of 16 * space). Style statistics are taken from the
    sharded style image with the same reduction. The output is sharded like
    the input. The stages' parameters are copied to each device once, here.
    """
    devices = mesh.devices[0]
    n_space = len(devices)
    params = {k: (_per_device(pyramid[k]["enc"], devices),
                  _per_device(pyramid[k]["dec"], devices)) for k in stages}
    down_max = 2 ** (max(stages) - 1)

    def fn(content, style, alpha):
        if len(content) != n_space or len(style) != n_space:
            raise ValueError(f"need {n_space} content and style shards, got "
                             f"{len(content)} and {len(style)}")
        if any(x.shape[1] % down_max for x in (*content, *style)):
            raise ValueError(
                f"per-shard H {content[0].shape[1]}/{style[0].shape[1]} must divide the "
                f"deepest stage's downsample factor {down_max}; pad the global H to a "
                f"multiple of {down_max} * n_space (the engine pads to 16 * space) so "
                f"pools and upsamples stay shard-local")
        img = content
        for k in stages:
            enc, dec = params[k]
            enc_spec, dec_spec = pyramid[k]["enc_spec"], pyramid[k]["dec_spec"]
            s_mean, s_cov = feature_stats_psum(
                apply_encoder_spatial(enc, style, enc_spec)["out"])
            c_out = apply_encoder_spatial(enc, img, enc_spec)["out"]
            csf = wct_transform_spatial(c_out, s_mean, s_cov, alpha, method=method,
                                        newton_iters=newton_iters)
            img = apply_decoder_spatial(dec, csf, dec_spec)
        return img

    return fn


# ---- slabs inside shards: the memory-bounded multi-device cascade. The
#      per-conv path above holds each shard's full feature maps; this one
#      bounds a shard's memory by the slab size. ----


def _exchange_row_halos(shards: list[torch.Tensor], hm: int) -> list[torch.Tensor]:
    """Extend every row shard with ``hm`` rows from each mesh neighbour:
    (N, H_loc, W, C) -> (N, H_loc + 2*hm, W, C). Global-edge shards get zero
    fill in the out-of-image region; callers must never read it (the slab
    index arithmetic below guarantees that)."""
    n = len(shards)
    for x in shards:
        if not x.shape[1] >= hm > 0:
            raise ValueError(f"halo of {hm} rows needs shards of at least as many "
                             f"rows, got {x.shape[1]}")
    return [_extend(x, shards[d - 1][:, -hm:] if d > 0 else None,
                    shards[d + 1][:, :hm] if d < n - 1 else None, hm)
            for d, x in enumerate(shards)]


def slab_coords(i: int, *, slab: int, m: int, hm: int, h_loc: int, n_slabs: int,
                is_first: bool, is_last: bool) -> tuple[int, int]:
    """(ext_start, interior_offset) for local slab ``i``, in the
    halo-extended image's coordinates (ext row 0 = local row -hm, hm = 2m).

    mid slabs: one margin each side (start local i*slab - m); the global-top
    shard's slab 0 starts at the TRUE boundary and extends inward (per-conv
    reflection there IS the reference's edge semantics); the global-bottom
    shard's last slab ends at the true boundary likewise. Every slab takes
    ``slab + hm`` rows."""
    start = i * slab + m          # mid: local i*slab - m -> ext +hm
    off = m
    if is_first and i == 0:
        start, off = hm, 0                  # local row 0
    if is_last and i == n_slabs - 1:
        start, off = h_loc - slab, hm       # local h - slab - 2m
    return start, off


def build_tiled_slab_cascade(pyramid, mesh: Mesh, *, stages=(5, 4, 3, 2, 1),
                             slab_rows: int = 1024, method: str = "eigh",
                             newton_iters: int = 24, eps: float = 1e-8,
                             data_axis: str | None = None,
                             external_style_stats: bool = False):
    """Row shards over ``space``, slab streaming inside each shard, WCT
    statistics added up across the mesh.

    * across devices: per stage, each shard takes ``2*margin`` input rows
      from each neighbour ONCE (not once per conv like
      :func:`build_tiled_stylize_fn`), then works on its own;
    * within a device: the shard streams through the stage in overlapping
      row slabs with :class:`..wct.slab.SlabCascade`'s own pass 1 and pass 2,
      so its peak memory is bounded by the slab size. Pass 2 encodes each
      slab again;
    * statistics: every shard's slab sums use ONE shift (the first shard's,
      copied to each device), are added on the first shard's device, and one
      coloring matrix is built there and copied: shards that each ran their
      own ``eigh`` could differ in the last bit and leave a seam.

    Slab-boundary semantics match :meth:`..wct.slab.SlabCascade._slabs`:
    interior slab margins come from recompute overlap (here possibly reaching
    into neighbour halos); the global top and bottom slabs start and end at
    the true image boundary.

    Returns ``fn(shards, style, alpha)``: ``shards`` is one (1, H_loc, W, 3)
    tensor per ``space`` device, on it, H_loc a positive multiple of
    ``fn.slab_rows`` (``slab_rows`` rounded up to the pyramid's granularity
    and to two margins); ``style`` is the style image (encoded whole, on the
    first shard's device) or, with ``external_style_stats``, ``{stage:
    (mean, cov)}``. The result is sharded like the input. With
    ``data_axis="data"`` ``shards`` and ``style`` are lists over the mesh's
    ``data`` rows, each row an independent image with its own statistics.
    """
    n_space = mesh.shape["space"]
    if n_space < 2:
        raise ValueError("use build_fused_slab_cascade for a single device")
    if data_axis not in (None, "data"):
        raise ValueError(f"data_axis must be None or 'data', got {data_axis!r}")
    if external_style_stats and data_axis is not None:
        raise ValueError("external_style_stats needs a space-only mesh (each data row "
                         "would need its own statistics)")
    kw = dict(stages=stages, method=method, newton_iters=newton_iters, eps=eps)
    plan = SlabCascade(pyramid, slab_rows=slab_rows, **kw)
    # edge slabs must share the mid-slab shape: round the request up to the
    # geometric minimum (callers read the effective size from fn.slab_rows)
    slab = max(plan.slab_rows, 2 * plan.margin)
    # one SlabCascade per distinct device, over that device's parameters
    helpers: dict = {}
    for row in mesh.devices:
        for dev in row:
            if dev not in helpers:
                helpers[dev] = SlabCascade(
                    {k: {**pyramid[k], "enc": _to(pyramid[k]["enc"], dev),
                         "dec": _to(pyramid[k]["dec"], dev)} for k in stages},
                    slab_rows=slab, **kw)

    def run_row(devices, shards, style, alpha):
        if len(shards) != n_space:
            raise ValueError(f"need {n_space} row shards, got {len(shards)}")
        h_loc = shards[0].shape[1]
        if h_loc < slab or h_loc % slab or any(x.shape[1] != h_loc for x in shards):
            raise ValueError(
                f"per-shard H {[x.shape[1] for x in shards]} must be one positive "
                f"multiple of slab_rows {slab}; pad global H to a multiple of "
                f"{slab * n_space}")
        n_slabs = h_loc // slab
        cas = [helpers[d] for d in devices]
        dev0 = devices[0]
        alphas = {dev: _alpha_on(alpha, dev) for dev in devices}
        for k in stages:
            mk = cas[0].margins[k]
            hm = 2 * mk  # halo rows: edge slabs extend inward by 2m
            s_mean, s_cov = style[k] if external_style_stats else cas[0].style_stats(
                k, style.to(dev0))
            ext = _exchange_row_halos(shards, hm)
            coords = [[(start, slab + hm, off) for start, off in (
                slab_coords(i, slab=slab, m=mk, hm=hm, h_loc=h_loc, n_slabs=n_slabs,
                            is_first=d == 0, is_last=d == n_space - 1)
                for i in range(n_slabs))] for d in range(n_space)]
            shift, s_sum, g_sum, count = None, 0.0, 0.0, 0
            for d, dev in enumerate(devices):
                first, s, g, n_px, _ = cas[d].slab_sums(
                    k, ext[d], coords[d], shift=None if shift is None else shift.to(dev))
                if shift is None:
                    shift = first   # the first shard's, on dev0, for every shard
                s_sum, g_sum, count = s_sum + s.to(dev0), g_sum + g.to(dev0), count + n_px
            c_mean, c_cov = stats_from_sums(shift, s_sum, g_sum, count)
            t = coloring_matrix(c_cov, s_cov.float().to(dev0), method=method, eps=eps,
                                newton_iters=newton_iters)
            shards = [cas[d].color_decode_stage(
                k, ext[d], t.to(dev), c_mean.to(dev), s_mean.float().to(dev), alphas[dev],
                slabs=coords[d]) for d, dev in enumerate(devices)]
        return shards

    def fn(shards, style, alpha):
        if data_axis is None:
            return run_row(mesh.devices[0], shards, style, alpha)
        if len(shards) != mesh.shape["data"] or len(style) != len(shards):
            raise ValueError(f"need {mesh.shape['data']} data rows of shards and styles")
        return [run_row(devices, row, sty, alpha)
                for devices, row, sty in zip(mesh.devices, shards, style)]

    fn.slab_rows = slab  # effective (possibly rounded-up) slab size
    return fn
