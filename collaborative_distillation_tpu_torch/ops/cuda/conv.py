"""Reflect-padded 3x3 conv: the ``conv3x3_reflect`` kernel and its plain version.

The kernel (``csrc/conv3x3.cu``) replaces the reference's Pallas
``conv3x3_tiled``, ``conv3x3_subin`` and ``conv3x3_lane128`` for plain NHWC
maps. :func:`launch_plan` picks, by shape alone, which of its templates runs:
a ring template at the cascade's widths, the first port's kernel at others.
:func:`conv3x3_plain` computes the same function with PyTorch ops; the CPU
path and the tests use it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..pad import reflect_pad
from . import _build

__all__ = ["conv3x3_plain", "conv3x3_reflect", "launch_plan", "device_plan", "ConvPlan"]

# The ring templates, by the id csrc/conv3x3.cu takes: (name, Cout tile, tile
# rows, tile cols), as it instantiates them. One persistent block an SM
# computes whole tiles for all of Cout.
_TEMPLATES = {
    1: ("ring_co128", 128, 8, 16),
    2: ("ring_co64", 64, 16, 16),
    3: ("ring_co32", 32, 16, 32),
    4: ("ring_co32_cin4", 32, 16, 32),
    5: ("ring_co16", 16, 32, 32),
    6: ("ring_co4", 4, 32, 64),
}
RING_WIDTHS = (3, 16, 24, 32, 64, 128)   # Cin and Cout the ring templates take
_FIRST_TILE = 16                         # the first kernel's square pixel tile
MAX_GRID_Z = 65535                       # CUDA's limit on gridDim.z


class ConvPlan(NamedTuple):
    """One launch: ``kernel`` (a template name or ``"first"``), ``template``
    (the id the C entry takes, 0 = first), the pixel ``tile`` (rows, cols),
    the Cout tile, the ``tiles`` of the whole batch and the ``grid``. The
    ring kernel's block ``b`` computes tiles ``b, b + grid[0], ...``; tile
    ``t`` is image ``t // per_image``, tile row and column ``divmod(t %
    per_image, tiles_w)``."""
    kernel: str
    template: int
    tile: tuple
    cout_tile: int
    tiles: int
    grid: tuple


def _template(cin: int, cout: int) -> int:
    if cin not in RING_WIDTHS or cout not in RING_WIDTHS:
        return 0
    if cout in (24, 32):
        return 4 if cin == 3 else 3
    return {128: 1, 64: 2, 16: 5, 3: 6}[cout]


def launch_plan(n: int, h: int, w: int, cin: int, cout: int, n_sm: int) -> ConvPlan:
    """The launch for an (n, h, w, cin) -> cout conv on a card of ``n_sm``
    SMs: a ring template where Cin and Cout are both widths of the cascade
    (one persistent block an SM, at most ``n_sm`` blocks), else the first
    kernel (a block per 16x16 tile and Cout tile). Fixed by shape; raises
    for a batch past the first kernel's grid limit."""
    t = _template(cin, cout)
    if t == 0:
        co_t = 32 if cout > 16 else 16 if cout > 8 else 8
        per_image = -(-h // _FIRST_TILE) * -(-w // _FIRST_TILE)
        if n > MAX_GRID_Z:
            raise ValueError(f"conv3x3_reflect: batch {n} > {MAX_GRID_Z} at Cin {cin}, "
                             f"Cout {cout}")
        return ConvPlan("first", 0, (_FIRST_TILE, _FIRST_TILE), co_t, n * per_image,
                        (per_image, -(-cout // co_t), n))
    name, co_t, th, tw = _TEMPLATES[t]
    tiles = n * -(-h // th) * -(-w // tw)
    return ConvPlan(name, t, (th, tw), co_t, tiles, (min(tiles, n_sm), 1, 1))


@functools.lru_cache(maxsize=1024)
def device_plan(n: int, h: int, w: int, cin: int, cout: int, index: int) -> ConvPlan:
    """:func:`launch_plan` on CUDA device ``index``."""
    return launch_plan(n, h, w, cin, cout,
                       torch.cuda.get_device_properties(index).multi_processor_count)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                  relu: bool) -> torch.Tensor:
    """Plain version of the kernel: reflect-pad(1) + 3x3 VALID conv (+ ReLU),
    NHWC x HWIO -> NHWC."""
    y = F.conv2d(reflect_pad(x, 1).permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b)
    y = y.permute(0, 2, 3, 1).contiguous()
    return torch.relu(y) if relu else y


def conv3x3_reflect(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                    relu: bool) -> torch.Tensor:
    """Launch the kernel: ``x`` (N, H, W, Cin), ``w`` (3, 3, Cin, Cout) HWIO,
    ``b`` (Cout,) or None, all contiguous float32 on one CUDA device ->
    (N, H, W, Cout), by the template :func:`launch_plan` picks."""
    if x.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"conv3x3_reflect: x {tuple(x.shape)} and HWIO w "
                         f"{tuple(w.shape)} do not match")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if not 1 <= cin <= 512 or not 1 <= cout <= 512:
        raise ValueError(f"conv3x3_reflect: Cin {cin}, Cout {cout} outside 1..512")
    if b is None:
        b = torch.zeros(cout, device=x.device, dtype=x.dtype)
    _check_cuda("conv3x3_reflect", x, w, b)
    if b.shape != (cout,):
        raise ValueError(f"conv3x3_reflect: bias {tuple(b.shape)} != ({cout},)")
    y = torch.empty((n, h, wd, cout), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    plan = device_plan(n, h, wd, cin, cout, x.device.index)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.cd_conv3x3_reflect(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, wd,
            cin, cout, int(relu), plan.template, plan.grid[0],
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv3x3_reflect")
    conv3x3_reflect.launches += 1
    return y


conv3x3_reflect.launches = 0
conv3x3_reflect.plain = conv3x3_plain


def _refuse_grad(name: str, *tensors: torch.Tensor | None) -> None:
    """A launch records no gradient: while autograd records, an input that
    requires grad is refused (``ops.conv`` launches the kernel inside its
    ``torch.autograd.Function`` for those), so no tensor that needs a
    gradient leaves a kernel without a ``grad_fn``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise ValueError(f"{name}: an input requires grad and the launch records none; "
                         f"call it through ops.conv, whose autograd Function launches it")


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous float32 tensors on one CUDA device, and
    no input that requires grad while autograd records."""
    _refuse_grad(name, *tensors)
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: needs CUDA tensors on one device, got "
                             f"{[str(u.device) for u in tensors]}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: needs float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
