"""Row halos: the ``halo_exchange_rows`` and ``halo_fill_rows`` kernels and
their plain versions.

``csrc/halo.cu`` replaces the reference's Pallas ``halo_exchange_rows_pallas``
(``ops/pallas/halo.py``). A row shard ``x`` (N, H, W, C) becomes (N, H +
2*hm, W, C): the shard in the middle, ``hm`` rows from each of two sources
above and below it, zeros where a source is ``None``. A source is ``hm`` rows
of a neighbour shard (a view of its last or first rows), or any other (N,
hm, W, C) rows whose images are contiguous, such as the shard's own
reflection row. Two uses of one kernel, which copies a table of row blocks
in one launch:

* :func:`halo_exchange_rows`, the reference's contract: a new extended map
  (:func:`halo_exchange_rows_many`: the shards of one card in one launch);
* :func:`halo_fill_rows`: only the ``2 * hm`` halo rows of extended maps
  whose interiors are already written, in place, the shards of one card in
  one launch (the slab-in-shard cascade decodes each stage straight into the
  next stage's extended shards).

The wrappers know nothing of meshes: who is whose neighbour is decided in
:mod:`...parallel.spatial`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .conv import _refuse_grad
from .peer import batch_stride, ptr, reachable, release

__all__ = ["halo_exchange_rows_plain", "halo_exchange_rows", "halo_exchange_rows_many",
           "halo_fill_rows_plain", "halo_fill_rows"]


def _check_rows(name: str, x: torch.Tensor, top, bot, hm: int) -> None:
    """What both versions refuse: shapes, ``hm`` and types that do not fit."""
    if x.dim() != 4:
        raise ValueError(f"{name}: needs an NHWC shard, got {tuple(x.shape)}")
    if not isinstance(hm, int) or hm <= 0:
        raise ValueError(f"{name}: hm must be a positive int, got {hm!r}")
    n, _, w, c = x.shape
    for side, t in (("top", top), ("bot", bot)):
        if t is None:
            continue
        if tuple(t.shape) != (n, hm, w, c):
            raise ValueError(f"{name}: {side} rows {tuple(t.shape)} != {(n, hm, w, c)}")
        if t.dtype != x.dtype:
            raise ValueError(f"{name}: {side} rows are {t.dtype}, the shard {x.dtype}")


def _check_extended(name: str, ext: torch.Tensor, top, bot, hm: int) -> None:
    """An extended shard (N, H + 2*hm, W, C) and its two sources."""
    _check_rows(name, ext, top, bot, hm)
    if ext.shape[1] < 2 * hm:
        raise ValueError(f"{name}: an extended shard of {ext.shape[1]} rows has no room "
                         f"for 2 * {hm} halo rows")


def halo_exchange_rows_plain(x: torch.Tensor, top: torch.Tensor | None,
                             bot: torch.Tensor | None, hm: int) -> torch.Tensor:
    """Plain version of the kernel: slices, a zeros tensor and ``torch.cat``
    (what the reference's ``_exchange_row_halos`` does with ``ppermute``)."""
    _check_rows("halo_exchange_rows_plain", x, top, bot, hm)
    n, _, w, c = x.shape
    zeros = x.new_zeros((n, hm, w, c))
    return torch.cat([zeros if top is None else top.to(x.device), x,
                      zeros if bot is None else bot.to(x.device)], dim=1)


def halo_fill_rows_plain(items, hm: int) -> None:
    """Plain version of :func:`halo_fill_rows`: per ``(ext, top, bot)`` one
    ``copy_`` or ``zero_`` into each of ext's two ``hm``-row halos."""
    items = list(items)
    for ext, top, bot in items:
        _check_extended("halo_fill_rows_plain", ext, top, bot, hm)
    for ext, top, bot in items:
        for dst, src in ((ext[:, :hm], top), (ext[:, ext.shape[1] - hm:], bot)):
            if src is None:
                dst.zero_()
            else:
                dst.copy_(src)


def _one_card(name: str, maps, items) -> torch.device:
    """The card of ``maps`` (contiguous), whose ``items``' sources are CUDA
    rows contiguous within each image; raises otherwise."""
    rows = [t for _, top, bot in items for t in (top, bot) if t is not None]
    if any(t.device.type != "cuda" for t in [*maps, *rows]):
        raise ValueError(f"{name}: needs CUDA tensors, got "
                         f"{sorted({str(t.device) for t in [*maps, *rows]})}")
    if not all(m.is_contiguous() for m in maps) or not all(t[0].is_contiguous() for t in rows):
        raise ValueError(f"{name}: needs contiguous shards and halo rows that are "
                         f"contiguous within each image")
    dev = maps[0].device
    if any(m.device != dev for m in maps):
        raise ValueError(f"{name}: one launch takes the shards of one card, got "
                         f"{sorted({str(m.device) for m in maps})}")
    return dev


def _copy(wrapper, dev: torch.device, blocks) -> None:
    """Copy row blocks on ``dev``'s current stream, counting the launches
    on ``wrapper`` (one for the blocks of one card unless the table is
    longer than one launch takes: ``csrc/halo.cu`` splits it). A block is
    ``(dst, row, rows, src)``: rows [row, row + rows) of ``dst``, a
    contiguous (N, R, W, C) map on ``dev``, from ``src``, (N, rows, W, C)
    rows contiguous within each image on any card (read in place through
    peer access, else copied first: :func:`.peer.reachable`), or zeros where
    ``src`` is ``None``."""
    blocks = [b for b in blocks if b[2] and b[0].numel()]
    if not blocks:
        return
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        srcs = [reachable(b[3], dev, stream) for b in blocks]
        flat = []
        for (dst, row, rows, _), src in zip(blocks, srcs):
            n, r, w, c = dst.shape
            size = dst.element_size()
            line = w * c * size
            flat += [ptr(src) or 0, dst.data_ptr() + row * line, rows * line, n,
                     batch_stride(src) * size, r * line]
        launches = ctypes.c_int(0)
        err = lib.cd_halo_copy_segments((ctypes.c_longlong * len(flat))(*flat), len(blocks),
                                        ctypes.byref(launches), stream.cuda_stream)
        wrapper.launches += launches.value
        _build.check(err, wrapper.__name__)
        for s in srcs:
            release(s, dev, stream)


def halo_exchange_rows_many(items, hm: int) -> list[torch.Tensor]:
    """The kernel for the shards of one card: ``items`` are ``(x, top,
    bot)``, ``x`` (N, H, W, C) contiguous on that card (H may differ between
    shards), ``top``, ``bot`` (N, hm, W, C) CUDA rows of x's type, each
    image's rows contiguous (any batch stride, any CUDA device), or ``None``
    for zeros -> one (N, H + 2*hm, W, C) map per item, on the card, in one
    launch (counted on :func:`halo_exchange_rows`)."""
    name = "halo_exchange_rows"
    items = list(items)
    if not items:
        return []
    for x, top, bot in items:
        _refuse_grad(name, x, top, bot)
        _check_rows(name, x, top, bot, hm)
    dev = _one_card(name, [x for x, _, _ in items], items)
    outs, blocks = [], []
    for x, top, bot in items:
        n, h, w, c = x.shape
        out = torch.empty((n, h + 2 * hm, w, c), device=dev, dtype=x.dtype)
        outs.append(out)
        blocks += [(out, 0, hm, top), (out, hm, h, x), (out, hm + h, hm, bot)]
    _copy(halo_exchange_rows, dev, blocks)
    return outs


def halo_exchange_rows(x: torch.Tensor, top: torch.Tensor | None,
                       bot: torch.Tensor | None, hm: int) -> torch.Tensor:
    """Launch the kernel: ``x`` (N, H, W, C) contiguous on a CUDA device;
    ``top``, ``bot`` (N, hm, W, C) CUDA rows of the same type, each image's
    rows contiguous (any batch stride, any CUDA device), or ``None`` for
    zeros -> (N, H + 2*hm, W, C) on ``x``'s device."""
    return halo_exchange_rows_many([(x, top, bot)], hm)[0]


def halo_fill_rows(items, hm: int) -> None:
    """Launch the kernel for the extended shards of one card: ``items`` are
    ``(ext, top, bot)``, ``ext`` (N, H + 2*hm, W, C) contiguous on that card
    with its interior rows [hm, hm + H) written; ``top``, ``bot`` as for
    :func:`halo_exchange_rows` (typically views of the neighbours' interior
    rows in their own extended shards). Writes ext's rows [0, hm) and [hm +
    H, H + 2*hm), and nothing else, in one launch."""
    name = "halo_fill_rows"
    items = list(items)
    if not items:
        return
    for ext, top, bot in items:
        _refuse_grad(name, ext, top, bot)
        _check_extended(name, ext, top, bot, hm)
    dev = _one_card(name, [ext for ext, _, _ in items], items)
    _copy(halo_fill_rows, dev, [block for ext, top, bot in items
                                for block in ((ext, 0, hm, top),
                                              (ext, ext.shape[1] - hm, hm, bot))])


halo_exchange_rows.launches = 0
halo_exchange_rows.plain = halo_exchange_rows_plain
halo_fill_rows.launches = 0
halo_fill_rows.plain = halo_fill_rows_plain
