"""One-pass feature statistics: the ``sum_gram`` kernel and its plain version.

The kernel (``csrc/sum_gram.cu``) replaces the reference's Pallas
``fused_sum_gram`` and adds an optional per-channel shift, so the caller can
take a Gram of nearly centred data (see :func:`..wct_transform.feature_stats`).
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .conv import _check_cuda

__all__ = ["sum_gram_plain", "sum_gram", "launch_plan"]

# Widths with the row kernel: rows staged per block (RB) and blocks per SM,
# as csrc/sum_gram.cu instantiates them. Each block holds the whole Gram and
# reads its row range once; one wave of blocks over the card.
_ROW_KERNEL = {24: (300, 2), 32: (250, 1), 64: (126, 1), 128: (64, 2)}
# Other widths (the tiled kernel): blocks of rows x (ceil(C / CT))^2 tiles.
_TILED_BLOCKS = 1056    # 8 blocks per SM on 132 SMs
_TILED_ROWS = 32        # rows staged per pass
_MIN_ROWS = 256         # rows per block below which the partials dominate


def launch_plan(p: int, c: int, n_sm: int) -> tuple[int, int]:
    """``(nblocks, rows_per_block)`` of one launch over a (p, c) matrix on a
    card of ``n_sm`` SMs: block k sums rows ``[k * rows, min(p, (k + 1) *
    rows))``, every block at least one row."""
    if c in _ROW_KERNEL:
        step, per_sm = _ROW_KERNEL[c]
        target = per_sm * n_sm
    else:
        step = _TILED_ROWS
        tiles = (-(-c // (32 if c <= 32 else 64))) ** 2
        target = max(1, min(-(-p // _MIN_ROWS), _TILED_BLOCKS // tiles))
    rows = -(-p // target)
    rows = -(-rows // step) * step
    return -(-p // rows), rows


@functools.lru_cache(maxsize=256)
def _device_plan(p: int, c: int, index: int) -> tuple[int, int]:
    return launch_plan(p, c, torch.cuda.get_device_properties(index).multi_processor_count)


def sum_gram_plain(x: torch.Tensor, shift: torch.Tensor | None = None):
    """Plain version: ``(sum(x - s) (C,), (x - s)^T (x - s) (C, C))``."""
    if shift is not None:
        x = x - shift
    return x.sum(0), x.T @ x


def sum_gram(x: torch.Tensor, shift: torch.Tensor | None = None):
    """Launch the kernel on a contiguous float32 (P, C) CUDA matrix, C <= 512,
    with an optional (C,) shift: the row kernel at C in 24/32/64/128, the
    tiled one at other widths, then the reduce (two CUDA launches, one count).
    Results repeat exactly from run to run: the partials of the row ranges
    are added in a fixed order."""
    if x.dim() != 2:
        raise ValueError(f"sum_gram: needs (P, C), got {tuple(x.shape)}")
    p, c = x.shape
    if not 1 <= c <= 512 or p < 1:
        raise ValueError(f"sum_gram: (P, C) = {(p, c)} outside P >= 1, C in 1..512")
    _check_cuda("sum_gram", x, *(() if shift is None else (shift,)))
    if shift is not None and shift.shape != (c,):
        raise ValueError(f"sum_gram: shift {tuple(shift.shape)} != ({c},)")
    nblocks, rows = _device_plan(p, c, x.device.index)
    partial = torch.empty((nblocks, c * c + c), device=x.device, dtype=torch.float32)
    out = torch.empty(c * c + c, device=x.device, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.cd_sum_gram(
            x.data_ptr(), None if shift is None else shift.data_ptr(),
            partial.data_ptr(), out.data_ptr(), p, c, nblocks, rows,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sum_gram")
    sum_gram.launches += 1
    return out[c * c:], out[:c * c].view(c, c)


sum_gram.launches = 0
sum_gram.plain = sum_gram_plain
