"""The 3x3 conv with the 2x2 max pool after it or the nearest 2x upsample
before it, in one launch: the kernels and their plain versions.

An encoder's conv before a pool and a decoder's conv after an upsample were
two launches each: the conv (``csrc/conv3x3.cu``, ``csrc/conv3x3_bf16.cu``)
and a pass of ``csrc/pool.cu`` over the full-resolution map. The ring conv
kernels' POOL instantiations pool their output tile in the epilogue and
write only the pooled map; their UP instantiations stage the conv's input
tile from the half-resolution map. Each computes the bits of the conv
followed by ``max_pool_2x2`` (``packed_pool_lane`` f=1, floor: an odd last
row or column is dropped) or of ``upsample_nearest_2x``
(``packed_upsample_lane``) followed by the conv, the reference's
``ops/pallas/pool.py:96`` and ``:141`` beside its conv.

The plans (:func:`.conv.launch_plan`, :func:`.conv.launch_plan_bf16` with
``fuse=``) have them only at the templates of the cascade's widths 16, 32,
64 and 128 (:func:`.conv.has_fused`) and raise elsewhere. Inference only: a
launch refuses an input that requires grad while autograd records.
"""

from __future__ import annotations

import torch

from . import _build
from .conv import (MAX_GRID_Z, FUSES, _check_cuda, conv3x3_plain, device_plan,
                   device_plan_bf16)
from .pool import max_pool_2x2_plain, upsample_nearest_2x_plain

__all__ = ["conv3x3_pool", "conv3x3_up", "conv3x3_pool_bf16", "conv3x3_up_bf16",
           "conv3x3_pool_plain", "conv3x3_up_plain"]


def conv3x3_pool_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                       relu: bool) -> torch.Tensor:
    """Plain version: :func:`.conv.conv3x3_plain` then
    :func:`.pool.max_pool_2x2_plain` (bfloat16: the pool of the once-rounded
    conv)."""
    return max_pool_2x2_plain(conv3x3_plain(x, w, b, relu))


def conv3x3_up_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                     relu: bool) -> torch.Tensor:
    """Plain version: :func:`.pool.upsample_nearest_2x_plain` of ``x``, then
    :func:`.conv.conv3x3_plain`."""
    return conv3x3_plain(upsample_nearest_2x_plain(x), w, b, relu)


def _launch(wrapper, fuse: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
            relu: bool, bf16: bool) -> torch.Tensor:
    """One launch of the fused instantiation the plan gives ``wrapper``'s
    shape; the conv's map is x's (pool) or twice x's (up)."""
    name = wrapper.__name__
    if x.dim() != 4 or w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"{name}: x {tuple(x.shape)} and HWIO w {tuple(w.shape)} do not match")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if not 1 <= cin <= 512 or not 1 <= cout <= 512:
        raise ValueError(f"{name}: Cin {cin}, Cout {cout} outside 1..512")
    if n > MAX_GRID_Z:
        raise ValueError(f"{name}: batch {n} > {MAX_GRID_Z}")
    dtype = torch.bfloat16 if bf16 else torch.float32
    if b is None:
        b = torch.zeros(cout, device=x.device, dtype=dtype)
    if b.shape != (cout,):
        raise ValueError(f"{name}: bias {tuple(b.shape)} != ({cout},)")
    if bf16:
        if b.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name}: bias must be bfloat16 or float32, got {b.dtype}")
        _check_cuda(name, x, w, b, dtype=(dtype, dtype, b.dtype))
    else:
        _check_cuda(name, x, w, b)
    hc, wc = (h, wd) if fuse == "pool" else (2 * h, 2 * wd)   # the conv's map
    out = (n, h // 2, wd // 2, cout) if fuse == "pool" else (n, hc, wc, cout)
    y = torch.empty(out, device=x.device, dtype=dtype)
    if y.numel() == 0:
        return y
    idx = x.device.index
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if bf16:
            plan = device_plan_bf16(n, hc, wc, cin, cout, idx, 9, fuse)
            err = lib.cd_conv3x3_bf16_fused(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, hc, wc, cin, cout,
                int(relu), int(b.dtype == torch.bfloat16), plan.template, plan.grid[0],
                int(plan.resident), FUSES[fuse], stream)
        else:
            plan = device_plan(n, hc, wc, cin, cout, idx, fuse)
            err = lib.cd_conv3x3_fused(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, hc, wc, cin, cout,
                int(relu), plan.template, plan.grid[0], FUSES[fuse], stream)
    _build.check(err, name)
    wrapper.launches += 1
    return y


def conv3x3_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                 relu: bool) -> torch.Tensor:
    """Launch the conv with its 2x2 max pool: ``x`` (N, H, W, Cin), ``w``
    (3, 3, Cin, Cout) HWIO, ``b`` (Cout,) or None, contiguous float32 on one
    CUDA device -> (N, H // 2, W // 2, Cout). A bfloat16 ``x`` goes to
    :func:`conv3x3_pool_bf16`."""
    if x.dtype == torch.bfloat16:
        return conv3x3_pool_bf16(x, w, b, relu)
    return _launch(conv3x3_pool, "pool", x, w, b, relu, False)


def conv3x3_up(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
               relu: bool) -> torch.Tensor:
    """Launch the conv of the nearest 2x upsample of ``x`` (N, H, W, Cin),
    float32 on one CUDA device -> (N, 2H, 2W, Cout); the upsampled map is
    never written. A bfloat16 ``x`` goes to :func:`conv3x3_up_bf16`."""
    if x.dtype == torch.bfloat16:
        return conv3x3_up_bf16(x, w, b, relu)
    return _launch(conv3x3_up, "up", x, w, b, relu, False)


def conv3x3_pool_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                      relu: bool) -> torch.Tensor:
    """:func:`conv3x3_pool` on bfloat16 ``x`` and ``w`` (``b`` bfloat16 or
    float32): the pool of the conv's once-rounded outputs."""
    return _launch(conv3x3_pool_bf16, "pool", x, w, b, relu, True)


def conv3x3_up_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                    relu: bool) -> torch.Tensor:
    """:func:`conv3x3_up` on bfloat16 ``x`` and ``w`` (``b`` bfloat16 or
    float32)."""
    return _launch(conv3x3_up_bf16, "up", x, w, b, relu, True)


for _k, _plain in ((conv3x3_pool, conv3x3_pool_plain), (conv3x3_up, conv3x3_up_plain),
                   (conv3x3_pool_bf16, conv3x3_pool_plain), (conv3x3_up_bf16, conv3x3_up_plain)):
    _k.launches = 0
    _k.plain = _plain
