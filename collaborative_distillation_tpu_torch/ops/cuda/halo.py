"""Row-halo exchange: the ``halo_exchange_rows`` kernel and its plain version.

``csrc/halo.cu`` replaces the reference's Pallas ``halo_exchange_rows_pallas``
(``ops/pallas/halo.py``). A row shard ``x`` (N, H, W, C) becomes
(N, H + 2*hm, W, C): the shard in the middle, ``hm`` rows from each of two
sources above and below it, zeros where a source is ``None``. A source is
``hm`` rows of a neighbour shard (a view of its last or first rows), or any
other (N, hm, W, C) rows whose images are contiguous, such as the shard's own
reflection row. The wrapper knows nothing of meshes: who is whose neighbour
is decided in :mod:`...parallel.spatial`.
"""

from __future__ import annotations

import torch

from . import _build
from .conv import _refuse_grad
from .peer import batch_stride, ptr, reachable, release

__all__ = ["halo_exchange_rows_plain", "halo_exchange_rows"]


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


def halo_exchange_rows_plain(x: torch.Tensor, top: torch.Tensor | None,
                             bot: torch.Tensor | None, hm: int) -> torch.Tensor:
    """Plain version of the kernel: slices, a zeros tensor and ``torch.cat``
    (what the reference's ``_exchange_row_halos`` does with ``ppermute``)."""
    _check_rows("halo_exchange_rows_plain", x, top, bot, hm)
    n, _, w, c = x.shape
    zeros = x.new_zeros((n, hm, w, c))
    return torch.cat([zeros if top is None else top.to(x.device), x,
                      zeros if bot is None else bot.to(x.device)], dim=1)


def halo_exchange_rows(x: torch.Tensor, top: torch.Tensor | None,
                       bot: torch.Tensor | None, hm: int) -> torch.Tensor:
    """Launch the kernel: ``x`` (N, H, W, C) contiguous on a CUDA device;
    ``top``, ``bot`` (N, hm, W, C) CUDA rows of the same type, each image's
    rows contiguous (any batch stride, any CUDA device), or ``None`` for
    zeros -> (N, H + 2*hm, W, C) on ``x``'s device."""
    name = "halo_exchange_rows"
    _refuse_grad(name, x, top, bot)
    _check_rows(name, x, top, bot, hm)
    rows = [t for t in (top, bot) if t is not None]
    if any(t.device.type != "cuda" for t in [x, *rows]):
        raise ValueError(f"{name}: needs CUDA tensors, got "
                         f"{[str(t.device) for t in [x, *rows]]}")
    if not x.is_contiguous() or not all(t[0].is_contiguous() for t in rows):
        raise ValueError(f"{name}: needs a contiguous shard and halo rows that are "
                         f"contiguous within each image")
    n, h, w, c = x.shape
    out = torch.empty((n, h + 2 * hm, w, c), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    lib = _build.library()
    size = x.element_size()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream()
        top, bot = reachable(top, x.device, stream), reachable(bot, x.device, stream)
        err = lib.cd_halo_exchange_rows(
            x.data_ptr(), ptr(top), ptr(bot), out.data_ptr(), n, h, hm, w * c * size,
            batch_stride(top) * size, batch_stride(bot) * size, stream.cuda_stream)
        release(top, x.device, stream)
        release(bot, x.device, stream)
    _build.check(err, name)
    halo_exchange_rows.launches += 1
    return out


halo_exchange_rows.launches = 0
halo_exchange_rows.plain = halo_exchange_rows_plain
