"""Spatially-tiled inference: the image's rows sharded over a device mesh.

One process drives all shards, so every function here takes and returns
**one tensor per shard**, in ``space`` order, each on its shard's device
(the reference writes the same functions per shard under ``shard_map``; the
lists take the place of its ``axis_name``). Two paths:

* per-conv halos (:func:`build_tiled_stylize_fn`): every reflect-pad 3x3 conv
  reads one-row halos from its mesh neighbours; at the two *global* edges
  the halo is the reference's reflection row, so tiled == untiled up to
  float32 reassociation. 2x2 pools and nearest upsamples are shard-local
  (every shard holds a multiple of the deepest stage's downsample factor;
  the engine deals whole 16-row blocks, so shards may differ in height).
  The content's WCT statistics are shard-local sums added up over the mesh
  (a covariance is a sum over pixels, so the tiling is exact) and one
  coloring matrix is built and copied to every shard; the style's come in
  whole;
* slabs inside shards (:func:`build_tiled_slab_cascade`): per stage each
  shard takes ``2 * margin`` rows from each neighbour once, then streams
  through its windows of the single-card slab plan on its own, so its peak
  memory is bounded by the slab size whatever the image's height.

With ``packed`` the slab path folds each encoder's ``conv0`` into its
``conv1_1`` once (:func:`..models.packed_vgg.pack_stage_params`) and copies
the folded trees to every device; :func:`build_tiled_stylize_fn_packed` is
the per-conv path over folded encoders, as the reference's function of that
name (without its width layout).

The per-conv halos go into no map of their own: ``conv3x3_reflect``
(:mod:`..ops.cuda.conv`) reads the neighbours' boundary rows in place while
it stages its tiles. The slab path extends the caller's shards once, at its
first stage (``halo_exchange_rows``, :mod:`..ops.cuda.halo`); every later
stage's extended shards are written in place: each stage decodes into the
interior of the next stage's, and ``halo_fill_rows`` fills only their halo
rows, one launch a card. CUDA shards launch the kernels, CPU shards take
their plain versions. Nothing here assumes distinct devices: a mesh may name
one card, or the CPU, for every shard.
"""

from __future__ import annotations

import torch

from ..models.packed_vgg import pack_stage_params
from ..models.specs import StageSpec
from ..models.vgg import runs_conv0
from ..ops.conv import conv1x1, conv3x3, max_pool_2x2, on_card, upsample_nearest_2x
from ..ops.cuda import halo as _khalo
from ..ops.cuda import peer as _peer
from ..ops.wct_transform import (alpha_on, coloring_matrix, gram_shift, shifted_sum_gram,
                                 stats_from_sums, wct_apply_folded)
from ..wct.slab import SlabCascade
from .mesh import Mesh

__all__ = [
    "halo_rows",
    "conv3x3_halo",
    "apply_encoder_spatial",
    "apply_encoder_spatial_packed",
    "apply_decoder_spatial",
    "feature_stats_psum",
    "wct_transform_spatial",
    "build_tiled_stylize_fn",
    "build_tiled_stylize_fn_packed",
    "shard_rows",
    "slab_coords",
    "build_tiled_slab_cascade",
]


def _to(tree, device):
    """A parameter tree (or a tensor) on ``device``, of the same dict types
    (a folded tree stays one); what lies there already is not copied."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)((k, _to(v, device)) for k, v in tree.items())


def _per_device(tree, devices):
    """One copy of ``tree`` per distinct device, listed once per shard."""
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = _to(tree, d)
    return [copies[d] for d in devices]


# ---- per-conv halos ----------------------------------------------------------

def halo_rows(xs: list[torch.Tensor]) -> list[tuple]:
    """Per shard (N, H, W, C) the ``(top, bot)`` one-row halos (N, 1, W, C)
    that its reflect-pad 3x3 conv reads above and below it: the neighbours'
    boundary rows, as views (nothing is copied), and at the two global edges
    the reference's ReflectionPad2d row (row 1 at the top, row H-2 at the
    bottom), which the conv takes from the shard itself: ``None`` there.
    The reference's ``halo_exchange_rows`` returns the same pair, its edge
    rows filled in."""
    n = len(xs)
    out = []
    for d, x in enumerate(xs):
        top = xs[d - 1][:, -1:] if d > 0 else None
        bot = xs[d + 1][:, :1] if d < n - 1 else None
        if x.shape[1] == 1:
            # single-row shards (deep pyramid levels): the global reflect row
            # is the *opposite-direction* halo: for the top shard, global
            # row 1 lives on shard 1 and is its bottom halo (and vice versa);
            # a single shard of one row reflects onto itself
            top, bot = (bot if top is None else top), (top if bot is None else bot)
        out.append((top, bot))
    return out


def conv3x3_halo(xs, ws, bs, *, relu: bool = True) -> list[torch.Tensor]:
    """Reflect-pad 3x3 conv whose H padding comes from the neighbours' halos;
    ``ws``, ``bs``: the layer's weight and bias on each shard's device. One
    conv per shard, on its own H rows: the kernel stages the halo rows where
    it would have reflected (its W reflection is the full image's). The
    layer's convs are one step across cards (:func:`..ops.cuda.peer.one_step`):
    each waits for its neighbours' previous layer, not for their convs."""
    with _peer.one_step([x.device for x in xs]):
        return [conv3x3(x, w, b, relu=relu, top=top, bot=bot)
                for x, (top, bot), w, b in zip(xs, halo_rows(xs), ws, bs)]


def _layer(params, name: str, kind: str):
    return [p[name][kind] for p in params]


def apply_encoder_spatial(params, xs, spec: StageSpec, *, aux_relu: bool = False):
    """Row-sharded mirror of :func:`..models.vgg.apply_encoder`: ``params``
    is the stage's parameter tree per shard, each named feature a list of
    shards. Folded trees skip ``conv0``, as there."""
    if spec.kind != "encoder":
        raise ValueError(f"apply_encoder_spatial needs an encoder spec, got {spec.kind!r}")
    outs = {}
    if any([runs_conv0(p, spec) for p in params]):
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


def apply_encoder_spatial_packed(params, xs, spec: StageSpec, **kw):
    """:func:`apply_encoder_spatial` over folded trees (no ``conv0`` step);
    any other tree raises."""
    if not all(getattr(p, "conv0_folded", False) for p in params):
        raise TypeError("apply_encoder_spatial_packed needs trees folded by pack_stage_params")
    return apply_encoder_spatial(params, xs, spec, **kw)


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
                             style_mean.to(f.device), alpha_on(alpha, f.device))
            for f in content_feats]


def build_tiled_stylize_fn(pyramid, mesh: Mesh, *, stages=(5, 4, 3, 2, 1),
                           method: str = "eigh", newton_iters: int = 24):
    """Row-sharded full cascade over ``mesh``'s ``space`` axis.

    Returns ``f(content, style_stats, alpha)``; content is a list of (N,
    H_loc, W, 3) row shards, one per ``space`` device and on it, each H_loc a
    positive multiple of the deepest stage's downsample factor (the shards
    may differ in height). ``style_stats`` is ``{stage: (mean, cov)}`` on any
    device, taken from the whole style image (the engine caches them per
    style). The output is sharded like the input. The stages' parameters are
    copied to each device once, here.
    """
    devices = mesh.devices[0]
    n_space = len(devices)
    params = {k: (_per_device(pyramid[k]["enc"], devices),
                  _per_device(pyramid[k]["dec"], devices)) for k in stages}
    down_max = 2 ** (max(stages) - 1)

    def fn(content, style_stats, alpha):
        if len(content) != n_space:
            raise ValueError(f"need {n_space} content shards, got {len(content)}")
        if any(x.shape[1] % down_max or not x.shape[1] for x in content):
            raise ValueError(
                f"per-shard H {[x.shape[1] for x in content]} must be positive multiples of "
                f"the deepest stage's downsample factor {down_max}, so that pools and "
                f"upsamples stay shard-local (the engine deals whole 16-row blocks)")
        img = content
        for k in stages:
            enc, dec = params[k]
            enc_spec, dec_spec = pyramid[k]["enc_spec"], pyramid[k]["dec_spec"]
            s_mean, s_cov = style_stats[k]
            c_out = apply_encoder_spatial(enc, img, enc_spec)["out"]
            csf = wct_transform_spatial(c_out, s_mean, s_cov, alpha, method=method,
                                        newton_iters=newton_iters)
            img = apply_decoder_spatial(dec, csf, dec_spec)
        return img

    return fn


def build_tiled_stylize_fn_packed(pyramid, mesh: Mesh, *, stages=(5, 4, 3, 2, 1),
                                  method: str = "eigh", newton_iters: int = 24,
                                  eps: float = 1e-8):
    """:func:`build_tiled_stylize_fn` over encoders whose ``conv0`` is folded
    into ``conv1_1``, folded once here and copied to each device; the
    reference's ``build_tiled_stylize_fn_packed`` without its width layout.

    Returns ``f(content, style, alpha)``: content and style are lists of
    row shards, one per ``space`` device and on it, each a positive multiple
    of the deepest stage's downsample factor high; the style is encoded in
    its shards as the content is (per-conv halos), its statistics added up
    over them. The output is sharded like the content."""
    devices = mesh.devices[0]
    n_space = len(devices)
    params = {k: (_per_device(pack_stage_params(pyramid[k]["enc"], pyramid[k]["enc_spec"]),
                              devices),
                  _per_device(pyramid[k]["dec"], devices)) for k in stages}
    down_max = 2 ** (max(stages) - 1)

    def fn(content, style, alpha):
        for name, xs in (("content", content), ("style", style)):
            if len(xs) != n_space:
                raise ValueError(f"need {n_space} {name} shards, got {len(xs)}")
            if any(x.shape[1] % down_max or not x.shape[1] for x in xs):
                raise ValueError(
                    f"per-shard {name} H {[x.shape[1] for x in xs]} must be positive "
                    f"multiples of the deepest stage's downsample factor {down_max}")
        img = content
        for k in stages:
            enc, dec = params[k]
            enc_spec, dec_spec = pyramid[k]["enc_spec"], pyramid[k]["dec_spec"]
            s_mean, s_cov = feature_stats_psum(
                apply_encoder_spatial_packed(enc, style, enc_spec)["out"])
            c_out = apply_encoder_spatial_packed(enc, img, enc_spec)["out"]
            csf = wct_transform_spatial(c_out, s_mean, s_cov, alpha, method=method, eps=eps,
                                        newton_iters=newton_iters)
            img = apply_decoder_spatial(dec, csf, dec_spec)
        return img

    return fn


# ---- slabs inside shards: the memory-bounded multi-device cascade. The
#      per-conv path above holds each shard's full feature maps; this one
#      bounds a shard's memory by the slab size. ----


def _check_halo(rows: list[int], hm: int) -> None:
    for r in rows:
        if not r >= hm > 0:
            raise ValueError(f"halo of {hm} rows needs shards of at least as many "
                             f"rows, got {r}")


def _cards(maps) -> dict:
    """{device: indices of ``maps`` on it}, in the order of first use."""
    groups: dict = {}
    for i, x in enumerate(maps):
        groups.setdefault(x.device, []).append(i)
    return groups


def _exchange_row_halos(shards: list[torch.Tensor], hm: int) -> list[torch.Tensor]:
    """Extend every row shard with ``hm`` rows from each mesh neighbour:
    (N, H_loc, W, C) -> (N, H_loc + 2*hm, W, C), one launch a card.
    Global-edge shards get zero fill in the out-of-image region; callers
    must never read it (the slab index arithmetic below guarantees that)."""
    n = len(shards)
    _check_halo([x.shape[1] for x in shards], hm)
    items = [(x, shards[d - 1][:, -hm:] if d > 0 else None,
              shards[d + 1][:, :hm] if d < n - 1 else None) for d, x in enumerate(shards)]
    out = [None] * n
    groups = _cards(shards)
    with _peer.one_step(list(groups)):
        for idx in groups.values():
            group = [items[i] for i in idx]
            exts = (_khalo.halo_exchange_rows_many(group, hm) if on_card(shards[idx[0]])
                    else [_khalo.halo_exchange_rows_plain(*item, hm) for item in group])
            for i, e in zip(idx, exts):
                out[i] = e
    return out


def _fill_row_halos(exts: list[torch.Tensor], hm: int) -> None:
    """In place, the ``hm``-row halos of every extended row shard (N, H_loc
    + 2*hm, W, C) whose interior rows [hm, hm + H_loc) are written: each
    neighbour's boundary interior rows, read where they lie, zeros at the
    global edges. The result is :func:`_exchange_row_halos`' on the
    interiors, one launch a card that moves only the halo rows."""
    n = len(exts)
    inner = [e[:, hm:e.shape[1] - hm] for e in exts]
    _check_halo([x.shape[1] for x in inner], hm)
    items = [(e, inner[d - 1][:, -hm:] if d > 0 else None,
              inner[d + 1][:, :hm] if d < n - 1 else None) for d, e in enumerate(exts)]
    groups = _cards(exts)
    with _peer.one_step(list(groups)):
        for idx in groups.values():
            fill = (_khalo.halo_fill_rows if on_card(exts[idx[0]])
                    else _khalo.halo_fill_rows_plain)
            fill([items[i] for i in idx], hm)


def shard_rows(h: int, slab: int, space: int) -> list[int]:
    """Rows of each of ``space`` row shards of an ``h``-row image under the
    global window plan (:meth:`..wct.slab.SlabCascade._slabs`): the ``h //
    slab`` whole windows dealt out in order, as evenly as they go, and the
    remainder (``h % slab`` rows) to the shard that owns the last whole
    window, so that no window reaches past a neighbour's ``2 * margin`` rows
    of halo. Shards past the windows get none and sit the image out; an
    image of fewer than ``slab`` rows is all the first shard's."""
    full, rest = divmod(h, slab)
    windows = [full // space + (d < full % space) for d in range(space)]
    rows = [n * slab for n in windows]
    rows[max((d for d in range(space) if windows[d]), default=0)] += rest
    return rows


def slab_coords(i: int, *, slab: int, m: int, hm: int, h_loc: int,
                is_first: bool, is_last: bool) -> tuple[int, int]:
    """(ext_start, interior_offset) for local window ``i``, in the
    halo-extended shard's coordinates (ext row 0 = local row -hm, hm = 2m);
    the window's interior is local rows [i*slab, min((i+1)*slab, h_loc)).

    Mid windows take one margin each side (start local i*slab - m); the
    global-top shard's window 0 starts at the TRUE boundary and extends
    inward (per-conv reflection there IS the reference's edge semantics);
    on the global-bottom shard a window that would end past the image is
    shifted up to end at its last row, its offset moved so that only its
    own rows count, as in :meth:`..wct.slab.SlabCascade._slabs`. Every
    window takes ``slab + hm`` rows."""
    start = i * slab + m          # mid: local i*slab - m -> ext +hm
    off = m
    if is_first and i == 0:
        start, off = hm, 0                  # local row 0
    if is_last and (i + 1) * slab + m > h_loc:
        start = h_loc - slab                # local h_loc - slab - 2m
        off = i * slab + hm - start
    return start, off


def build_tiled_slab_cascade(pyramid, mesh: Mesh, *, stages=(5, 4, 3, 2, 1),
                             slab_rows: int = 1024, method: str = "eigh",
                             newton_iters: int = 24, eps: float = 1e-8,
                             packed: bool = False, data_axis: str | None = None,
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

    The windows are the single-card plan's over the whole image
    (:meth:`..wct.slab.SlabCascade._slabs`), dealt out to the shards whole
    (:func:`shard_rows`): interior margins come from recompute overlap (here
    possibly reaching into neighbour halos); the global top window starts at
    the true image boundary and the last ones end at it, shifted up where
    the image's height is no slab multiple. Nothing is padded.

    Returns ``fn(shards, style, alpha)``: ``shards`` is one (1, H_loc, W, 3)
    tensor per ``space`` device, on it, the rows cut as ``shard_rows(H,
    fn.slab_rows, space)`` deals them (``slab_rows`` rounded up to the
    pyramid's granularity and to two margins; a shard of no rows sits the
    image out), H a multiple of the granularity; ``style`` is the style
    image (encoded whole, on the first shard's device) or, with
    ``external_style_stats``, ``{stage: (mean, cov)}``. The result is sharded like the input. With
    ``data_axis="data"`` ``shards`` and ``style`` are lists over the mesh's
    ``data`` rows, each row an independent image with its own statistics.

    ``packed``: every encoder's ``conv0`` folded into its ``conv1_1``, once,
    and the folded trees copied to each device, so that every shard runs the
    same weights (the style image, where it is encoded here, too).
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
    plan = SlabCascade(pyramid, slab_rows=slab_rows, packed=packed, **kw)
    # edge slabs must share the mid-slab shape: round the request up to the
    # geometric minimum (callers read the effective size from fn.slab_rows)
    slab = max(plan.slab_rows, 2 * plan.margin)
    # one SlabCascade per distinct device, over that device's copy of the
    # plan's trees (folded once, by the plan, with ``packed``)
    helpers: dict = {}
    for row in mesh.devices:
        for dev in row:
            if dev not in helpers:
                trees = _to(plan.params, dev)
                helpers[dev] = SlabCascade({k: {**pyramid[k], **trees[k]} for k in stages},
                                           slab_rows=slab, packed=packed,
                                           packed_params=trees if packed else None, **kw)

    def run_row(devices, shards, style, alpha):
        if len(shards) != n_space:
            raise ValueError(f"need {n_space} row shards, got {len(shards)}")
        sizes = [x.shape[1] for x in shards]
        h = sum(sizes)
        if h < 1 or h % plan.down_max or sizes != shard_rows(h, slab, n_space):
            raise ValueError(
                f"per-shard H {sizes} must follow the global window plan: a "
                f"multiple of slab_rows {slab} per shard, in order, the remainder on "
                f"the last shard that owns a whole window (shard_rows({h}, {slab}, "
                f"{n_space}) = {shard_rows(h, slab, n_space)}), H a multiple of "
                f"{plan.down_max}")
        live = [d for d in range(n_space) if sizes[d]]   # the others sit out
        devs = [devices[d] for d in live]
        cas = [helpers[dev] for dev in devs]
        dev0 = devs[0]
        alphas = {dev: alpha_on(alpha, dev) for dev in devs}
        parts = [shards[d] for d in live]
        ext = None   # the stage's extended shards, written by the stage before
        for i, k in enumerate(stages):
            mk = cas[0].margins[k]
            hm = 2 * mk  # halo rows: edge windows extend inward by 2m
            s_mean, s_cov = style[k] if external_style_stats else cas[0].style_stats(
                k, style.to(dev0))
            if len(parts) == 1:
                # one shard holds the whole image: the single-card plan
                ext, coords = parts, [list(cas[0]._slabs(h, k))]
            else:
                if ext is None:
                    ext = _exchange_row_halos(parts, hm)   # the caller's shards, whole
                else:
                    _fill_row_halos(ext, hm)
                coords = [[(start, slab + hm, off, min(slab, x.shape[1] - i * slab))
                           for i in range(-(-x.shape[1] // slab))
                           for start, off in [slab_coords(
                               i, slab=slab, m=mk, hm=hm, h_loc=x.shape[1],
                               is_first=j == 0, is_last=j == len(parts) - 1)]]
                          for j, x in enumerate(parts)]
            shift, s_sum, g_sum, count = None, 0.0, 0.0, 0
            for j, dev in enumerate(devs):
                first, s, g, n_px, _ = cas[j].slab_sums(
                    k, ext[j], coords[j], shift=None if shift is None else shift.to(dev))
                if shift is None:
                    shift = first   # the first shard's, on dev0, for every shard
                s_sum, g_sum, count = s_sum + s.to(dev0), g_sum + g.to(dev0), count + n_px
            c_mean, c_cov = stats_from_sums(shift, s_sum, g_sum, count)
            t = coloring_matrix(c_cov, s_cov.float().to(dev0), method=method, eps=eps,
                                newton_iters=newton_iters)
            # each shard decodes into the interior of its extended shard of
            # the next stage (a plain one after the last stage), allocated
            # just before; its input goes as soon as it is decoded
            hn = (2 * cas[0].margins[stages[i + 1]]
                  if i + 1 < len(stages) and len(parts) > 1 else 0)
            nxt = []
            for j, dev in enumerate(devs):
                n_img, rows, *rest = parts[j].shape
                nxt.append(parts[j].new_empty((n_img, rows + 2 * hn, *rest)))
                cas[j].color_decode_stage(
                    k, ext[j], t.to(dev), c_mean.to(dev), s_mean.float().to(dev), alphas[dev],
                    slabs=coords[j], out=nxt[j][:, hn:hn + rows])
                ext[j] = parts[j] = None
            parts = [x[:, hn:x.shape[1] - hn] for x in nxt]
            ext = nxt if hn else None
        out = list(shards)
        for d, x in zip(live, parts):
            out[d] = x
        return out

    def fn(shards, style, alpha):
        if data_axis is None:
            return run_row(mesh.devices[0], shards, style, alpha)
        if len(shards) != mesh.shape["data"] or len(style) != len(shards):
            raise ValueError(f"need {mesh.shape['data']} data rows of shards and styles")
        return [run_row(devices, row, sty, alpha)
                for devices, row, sty in zip(mesh.devices, shards, style)]

    fn.slab_rows = slab  # effective (possibly rounded-up) slab size
    return fn
