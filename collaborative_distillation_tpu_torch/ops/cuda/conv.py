"""Reflect-padded 3x3 conv: the ``conv3x3_reflect`` kernel and its plain version.

The kernel (``csrc/conv3x3.cu``) replaces the reference's Pallas
``conv3x3_tiled``, ``conv3x3_subin`` and ``conv3x3_lane128`` for plain NHWC
maps. :func:`launch_plan` picks, by shape alone, which of its templates runs:
a ring template where Cin and Cout are widths of the cascade or of the
VGG-19 teachers (3 to 512; at the teachers' 256 and 512 one that walks the
Cout in tiles of 64), the first port's kernel at any other width.
:func:`conv3x3_plain` computes the same function with PyTorch ops; the CPU
path and the tests use it.

Both take optional halo rows, ``top`` and ``bot``: for a shard of a
row-sharded map, the rows that stand above and below it (the neighbour
shards' boundary rows, read in place), as the reference's
``parallel/spatial.py:conv3x3_halo`` convolves a shard: its rows between
them, reflect-padded in W only. A row that is ``None`` is the shard's own
reflection row, as without halos.

bfloat16 maps take :func:`conv3x3_reflect_bf16` (``csrc/conv3x3_bf16.cu``,
tensor cores, f32 sums rounded once to bf16), the reference's bf16
instantiation of the same Pallas kernels, halo rows included (bf16 rows,
read in place by its staging as the float32 kernel reads them);
:func:`conv3x3_plain` computes it in float32 and rounds once.
:func:`launch_plan_bf16` picks the template of its persistent ring kernel
(``csrc/bf16_igemm.cuh``), and that of the bf16 1x1's.

Both plans take ``fuse``: ``"pool"`` for the conv with the 2x2 max pool
after it, ``"up"`` for the conv with the nearest 2x upsample before it (the
kernels' POOL and UP instantiations, :mod:`.fused`). Those exist only at the
ring templates of ``FUSED_TEMPLATES`` and ``BF16_FUSED_TEMPLATES`` (bf16:
with resident weights), the ones the plans pick at the cascade's widths 16,
32, 64 and 128; elsewhere the plan raises, and :func:`has_fused` says so
beforehand.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..pad import reflect_index, reflect_pad
from ..precision import full_float32
from . import _build
from .peer import batch_stride, ptr, reachable, release

__all__ = ["conv3x3_plain", "conv3x3_reflect", "conv3x3_reflect_bf16", "launch_plan",
           "device_plan", "ConvPlan", "launch_plan_bf16", "device_plan_bf16", "BF16Plan",
           "FUSES", "FUSED_TEMPLATES", "BF16_FUSED_TEMPLATES", "has_fused"]

# The ring templates, by the id csrc/conv3x3.cu takes: (name, Cout tile, tile
# rows, tile cols), as it instantiates them. One persistent block an SM
# computes whole tiles for all of Cout, or (ring_walk*) for one Cout tile of
# a wider Cout at a time.
_TEMPLATES = {
    1: ("ring_co128", 128, 8, 16),
    2: ("ring_co64", 64, 16, 16),
    3: ("ring_co32", 32, 16, 32),
    4: ("ring_co32_cin4", 32, 16, 32),
    5: ("ring_co16", 16, 32, 32),
    6: ("ring_co4", 4, 32, 64),
    7: ("ring_walk64", 64, 16, 16),
}
RING_WIDTHS = (3, 16, 24, 32, 64, 128, 256, 512)   # Cin and Cout the ring templates take
# The ring templates with a fused pool / upsample instantiation (csrc/
# conv3x3.cu's cd_conv3x3_fused), and the C entries' ids of the two
FUSED_TEMPLATES = frozenset({1, 2, 3, 5})
FUSES = {"pool": 1, "up": 2}
_FIRST_TILE = 16                         # the first kernel's square pixel tile
MAX_GRID_Z = 65535                       # CUDA's limit on gridDim.z


class ConvPlan(NamedTuple):
    """One launch: ``kernel`` (a template name or ``"first"``), ``template``
    (the id the C entry takes, 0 = first), the pixel ``tile`` (rows, cols),
    the Cout tile, the ``tiles`` of the whole batch (the ring kernel's work
    items: pixel tiles x Cout tiles) and the ``grid``. The ring kernel's
    block ``b`` computes items ``b, b + grid[0], ...``; item ``i`` is pixel
    tile ``i // cout_tiles``, Cout tile ``i % cout_tiles``; pixel tile ``t``
    is image ``t // per_image``, tile row and column ``divmod(t % per_image,
    tiles_w)``. For the first kernel ``tiles`` counts pixel tiles."""
    kernel: str
    template: int
    tile: tuple
    cout_tile: int
    tiles: int
    grid: tuple


def _template(cin: int, cout: int) -> int:
    if cin not in RING_WIDTHS or cout not in RING_WIDTHS:
        return 0
    if max(cin, cout) > 128 and cout >= 64:
        return 7
    if cout in (24, 32):
        return 4 if cin == 3 else 3
    return {128: 1, 64: 2, 16: 5, 3: 6}[cout]


def _check_fuse(fuse: str | None, t: int, templates, cin: int, cout: int, dtype: str) -> None:
    if fuse is not None and fuse not in FUSES:
        raise ValueError(f"fuse must be None, 'pool' or 'up', got {fuse!r}")
    if fuse is not None and t not in templates:
        raise ValueError(f"conv3x3 ({dtype}): no fused {fuse} instantiation at Cin {cin}, "
                         f"Cout {cout} (template {t}; fused: {sorted(templates)})")


def launch_plan(n: int, h: int, w: int, cin: int, cout: int, n_sm: int,
                fuse: str | None = None) -> ConvPlan:
    """The launch for an (n, h, w, cin) -> cout conv on a card of ``n_sm``
    SMs: a ring template where Cin and Cout are both widths of the cascade
    or the teachers (one persistent block an SM, at most ``n_sm`` blocks),
    else the first kernel (a block per 16x16 tile and Cout tile). Fixed by
    shape; raises for a batch past the first kernel's grid limit. ``fuse``
    (``"pool"``, ``"up"``): the template's fused instantiation, (h, w) the
    conv's map; raises where the template has none."""
    t = _template(cin, cout)
    _check_fuse(fuse, t, FUSED_TEMPLATES, cin, cout, "float32")
    if t == 0:
        co_t = 32 if cout > 16 else 16 if cout > 8 else 8
        per_image = -(-h // _FIRST_TILE) * -(-w // _FIRST_TILE)
        if n > MAX_GRID_Z:
            raise ValueError(f"conv3x3_reflect: batch {n} > {MAX_GRID_Z} at Cin {cin}, "
                             f"Cout {cout}")
        return ConvPlan("first", 0, (_FIRST_TILE, _FIRST_TILE), co_t, n * per_image,
                        (per_image, -(-cout // co_t), n))
    return ring_plan(t, n, h, w, cout, n_sm)


def ring_plan(t: int, n: int, h: int, w: int, cout: int, n_sm: int) -> ConvPlan:
    """Ring template ``t``'s launch: one work item per pixel tile and Cout
    tile, one persistent block an SM."""
    name, co_t, th, tw = _TEMPLATES[t]
    items = n * -(-h // th) * -(-w // tw) * -(-cout // co_t)
    return ConvPlan(name, t, (th, tw), co_t, items, (min(items, n_sm), 1, 1))


@functools.lru_cache(maxsize=1024)
def device_plan(n: int, h: int, w: int, cin: int, cout: int, index: int,
                fuse: str | None = None) -> ConvPlan:
    """:func:`launch_plan` on CUDA device ``index``."""
    return launch_plan(n, h, w, cin, cout,
                       torch.cuda.get_device_properties(index).multi_processor_count, fuse)


# The bf16 ring templates, by the id the C entries take: (name, taps, CK, NT,
# TH, TW, S, warps, wgmma) as csrc/conv3x3_bf16.cu (taps 9) and
# csrc/conv1x1.cu (taps 1) instantiate them: CK input channels a step
# stages (the 1x1: at most), NT couts a block, a TH x TW pixel tile (the
# 1x1: TH * TW consecutive pixels), S ring slots, the warps of a block,
# whether the products are wgmma (1) or mma.sync (0).
BF16_TEMPLATES = {
    1: ("bf16_ck8_co16", 9, 8, 16, 32, 32, 3, 16, 0),
    2: ("bf16_ck8_co32", 9, 8, 32, 16, 32, 3, 16, 0),
    3: ("bf16_ck16_co8", 9, 16, 8, 32, 32, 3, 16, 0),
    4: ("bf16_ck16_co16", 9, 16, 16, 32, 32, 3, 16, 0),
    5: ("bf16_ck16_co32", 9, 16, 32, 16, 32, 3, 16, 0),
    6: ("bf16_ck24_co8", 9, 24, 8, 32, 32, 3, 16, 0),
    7: ("bf16_ck32_co16", 9, 32, 16, 16, 32, 3, 16, 0),
    8: ("bf16_ck32_co32", 9, 32, 32, 16, 32, 3, 16, 0),
    9: ("bf16_ck32_co64", 9, 32, 64, 16, 16, 3, 8, 1),
    10: ("bf16_ck32_co64_s2", 9, 32, 64, 16, 16, 2, 8, 1),
    11: ("bf16_1x1_c32", 1, 32, 32, 32, 16, 4, 16, 0),
    12: ("bf16_1x1_c64", 1, 64, 64, 16, 16, 3, 8, 0),
    13: ("bf16_1x1_c128", 1, 128, 128, 8, 16, 3, 8, 0),
}
MAX_SMEM = 232448   # an H100 block's opt-in dynamic shared memory, bytes
# the bf16 3x3 templates with a fused pool / upsample instantiation
# (csrc/conv3x3_bf16.cu's cd_conv3x3_bf16_fused), with resident weights
BF16_FUSED_TEMPLATES = frozenset({4, 8, 9, 10})


class BF16Plan(NamedTuple):
    """One launch of the bf16 ring kernel: ``kernel`` (the template's name),
    ``template`` (its id), the pixel ``tile`` (rows, cols), the Cout tile,
    the Cin ``chunks`` a tile takes, whether the weights are ``resident``
    (else streamed a chunk a step), its dynamic shared memory ``smem`` in
    bytes, the pixel ``tiles`` of the whole batch and the ``grid`` (whole
    Cout tiles of blocks: block ``b`` keeps Cout tile ``b % cout_tiles`` and
    walks pixel tiles ``b // cout_tiles``, + ``grid // cout_tiles``, ...)."""
    kernel: str
    template: int
    tile: tuple
    cout_tile: int
    chunks: int
    resident: bool
    smem: int
    tiles: int
    grid: tuple


def bf16_smem(t: int, cin: int, resident: bool) -> int:
    """Template ``t``'s dynamic shared memory at ``cin`` (bf16_igemm.cuh's
    ``smem_bytes``): S pixel slots of SP staged pixels at a stride of an odd
    number of 16-byte units, the weights (every chunk, or one a slot), the
    warps' output staging, 16 zero bytes."""
    _, taps, ck, nt, th, tw, s, _, _ = BF16_TEMPLATES[t]
    xs = ck + 8 if (ck // 8) % 2 == 0 else ck
    sp = (th + 2) * (tw + 2) if taps == 9 else th * tw
    groups = ck // 8 if taps == 9 else -(-cin // 8)
    k_rows = -(-taps * groups * 8 // 16) * 16
    chunks = -(-cin // ck) if taps == 9 else 1
    return 2 * (s * sp * xs + (chunks if resident else s) * k_rows * nt + th * tw * nt) + 16


def _bf16_template(cin: int, cout: int, taps: int) -> tuple[int, bool]:
    """(template, resident) for a conv: the smallest staged width and Cout
    tile that hold Cin (up to a 32-channel chunk) and Cout (up to 64; wider
    Cout walks tiles of 64); resident weights where they fit beside the
    ring, else the two-slot template, streamed where even that one cannot
    hold them. The 1x1 by the wider of Cin and Cout, all of Cout a block."""
    if taps == 1:
        wide = max(-(-cin // 8) * 8, cout)
        return (11 if wide <= 32 else 12 if wide <= 64 else 13), True
    ck = min(32, -(-cin // 8) * 8)
    nt = 8 if cout <= 8 else 16 if cout <= 16 else 32 if cout <= 32 else 64
    fits = [t for t, (_, tp, c, n, *_rest) in sorted(BF16_TEMPLATES.items(),
                                                     key=lambda kv: kv[1][2:4])
            if tp == 9 and c >= ck and n >= nt and bf16_smem(t, cin, True) <= MAX_SMEM]
    return (fits[0], True) if fits else (10, False)


def launch_plan_bf16(n: int, h: int, w: int, cin: int, cout: int, n_sm: int,
                     taps: int = 9, fuse: str | None = None) -> BF16Plan:
    """The bf16 ring kernel's launch for an (n, h, w, cin) -> cout conv
    (``taps=9``, the 3x3) or a 1x1 over n * h * w pixels (``taps=1``) on a
    card of ``n_sm`` SMs: the template by width (:func:`_bf16_template`),
    one persistent block an SM in whole Cout tiles, no more blocks on a Cout
    tile than there are pixel tiles. Fixed by shape. ``fuse`` (the 3x3's
    ``"pool"`` or ``"up"``, (h, w) the conv's map): the fused instantiation,
    raising where the template has none or streams its weights."""
    t, resident = _bf16_template(cin, cout, taps)
    if fuse is not None:   # the 3x3's resident-weight templates only
        _check_fuse(fuse, t, BF16_FUSED_TEMPLATES if taps == 9 and resident else frozenset(),
                    cin, cout, "bfloat16")
    name, _, ck, nt, th, tw, _, _, _ = BF16_TEMPLATES[t]
    if taps == 1:
        tiles = -(-(n * h * w) // (th * tw))
        cout_tiles, chunks = 1, 1
    else:
        tiles = n * -(-h // th) * -(-w // tw)
        cout_tiles, chunks = -(-cout // nt), -(-cin // ck)
    walkers = max(1, min(tiles, n_sm // cout_tiles))   # blocks on each Cout tile
    return BF16Plan(name, t, (th, tw), nt, chunks, resident, bf16_smem(t, cin, resident),
                    tiles, (walkers * cout_tiles, 1, 1))


@functools.lru_cache(maxsize=1024)
def device_plan_bf16(n: int, h: int, w: int, cin: int, cout: int, index: int,
                     taps: int = 9, fuse: str | None = None) -> BF16Plan:
    """:func:`launch_plan_bf16` on CUDA device ``index``."""
    return launch_plan_bf16(n, h, w, cin, cout,
                            torch.cuda.get_device_properties(index).multi_processor_count, taps,
                            fuse)


def has_fused(cin: int, cout: int, dtype: torch.dtype) -> bool:
    """Whether the launch plan has a fused pool / upsample instantiation
    for a (cin -> cout) 3x3 conv on ``dtype`` maps (float32 or bfloat16):
    what ``fuse=`` of :func:`launch_plan` / :func:`launch_plan_bf16` takes
    without raising."""
    if dtype == torch.bfloat16:
        t, resident = _bf16_template(cin, cout, 9)
        return resident and t in BF16_FUSED_TEMPLATES
    return dtype == torch.float32 and _template(cin, cout) in FUSED_TEMPLATES


def _check_halo(name: str, x: torch.Tensor, top, bot) -> None:
    """What both versions refuse of halo rows: each (N, 1, W, Cin) of x's
    type, its images' rows contiguous (any batch stride)."""
    n, _, w, c = x.shape
    for side, t in (("top", top), ("bot", bot)):
        if t is None:
            continue
        if tuple(t.shape) != (n, 1, w, c):
            raise ValueError(f"{name}: {side} row {tuple(t.shape)} != {(n, 1, w, c)}")
        if t.dtype != x.dtype:
            raise ValueError(f"{name}: {side} row is {t.dtype}, x {x.dtype}")
        if not t[0].is_contiguous():
            raise ValueError(f"{name}: {side} row must be contiguous within each image")


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                  relu: bool, *, top: torch.Tensor | None = None,
                  bot: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the kernel: reflect-pad(1) + 3x3 VALID conv (+ ReLU),
    NHWC x HWIO -> NHWC. With halo rows, the reference's ``conv3x3_halo``:
    ``[top, x, bot]`` along H (the shard's own reflection row where one is
    ``None``), reflect-padded in W only, then the VALID conv.

    A bfloat16 ``x`` (and ``w``, halo rows; ``b`` bf16 or f32): the conv of
    the values upcast to float32 in full float32 (the products are exact),
    bias and ReLU in float32, then one rounding to bf16, as the bf16 kernel
    rounds. ``F.conv2d`` is never called on bf16 CPU tensors, which round
    elsewhere."""
    if x.dtype == torch.bfloat16:
        _check_halo("conv3x3_plain", x, top, bot)
        up = [None if t is None else t.float() for t in (b, top, bot)]
        with full_float32():
            y = conv3x3_plain(x.float(), w.float(), up[0], relu, top=up[1], bot=up[2])
        return y.to(torch.bfloat16)
    if top is None and bot is None:
        xp = reflect_pad(x, 1)
    else:
        _check_halo("conv3x3_plain", x, top, bot)
        h = x.shape[1]
        edge_top, edge_bot = (x[:, 1:2], x[:, -2:-1]) if h >= 2 else (x, x)
        rows = torch.cat([edge_top if top is None else top.to(x.device), x,
                          edge_bot if bot is None else bot.to(x.device)], dim=1)
        xp = rows.index_select(2, reflect_index(x.shape[2], 1, 1, x.device))
    y = F.conv2d(xp.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b)
    y = y.permute(0, 2, 3, 1).contiguous()
    return torch.relu(y) if relu else y


def conv3x3_reflect(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                    relu: bool, *, top: torch.Tensor | None = None,
                    bot: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel: ``x`` (N, H, W, Cin), ``w`` (3, 3, Cin, Cout) HWIO,
    ``b`` (Cout,) or None, all contiguous float32 on one CUDA device ->
    (N, H, W, Cout), by the template :func:`launch_plan` picks. ``top``,
    ``bot``: (N, 1, W, Cin) float32 CUDA rows, each image's row contiguous,
    on any card, or None; the staging reads them in place (counted in
    ``conv3x3_reflect.halo_launches`` too). ``conv3x3_reflect.by_template``
    counts the launches by the plan's template name. A bfloat16 ``x`` goes
    to :func:`conv3x3_reflect_bf16`, its halo rows with it."""
    name = "conv3x3_reflect"
    if x.dtype == torch.bfloat16:
        return conv3x3_reflect_bf16(x, w, b, relu, top=top, bot=bot)
    if x.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"{name}: x {tuple(x.shape)} and HWIO w "
                         f"{tuple(w.shape)} do not match")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if not 1 <= cin <= 512 or not 1 <= cout <= 512:
        raise ValueError(f"{name}: Cin {cin}, Cout {cout} outside 1..512")
    if b is None:
        b = torch.zeros(cout, device=x.device, dtype=x.dtype)
    rows = [t for t in (top, bot) if t is not None]
    _check_cuda(name, x, w, b, rows=rows)
    if b.shape != (cout,):
        raise ValueError(f"{name}: bias {tuple(b.shape)} != ({cout},)")
    _check_halo(name, x, top, bot)
    y = torch.empty((n, h, wd, cout), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    plan = device_plan(n, h, wd, cin, cout, x.device.index)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream()
        top, bot = reachable(top, x.device, stream), reachable(bot, x.device, stream)
        err = lib.cd_conv3x3_reflect(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), ptr(top), ptr(bot),
            batch_stride(top), batch_stride(bot), n, h, wd, cin, cout, int(relu),
            plan.template, plan.grid[0], stream.cuda_stream)
        release(top, x.device, stream)
        release(bot, x.device, stream)
    _build.check(err, name)
    conv3x3_reflect.launches += 1
    conv3x3_reflect.halo_launches += bool(rows)
    conv3x3_reflect.by_template[plan.kernel] += 1
    return y


conv3x3_reflect.launches = 0
conv3x3_reflect.halo_launches = 0
conv3x3_reflect.by_template = Counter()
conv3x3_reflect.plain = conv3x3_plain


def conv3x3_reflect_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                         relu: bool, *, top: torch.Tensor | None = None,
                         bot: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the bf16 kernel (``csrc/conv3x3_bf16.cu``): ``x`` (N, H, W,
    Cin) and ``w`` (3, 3, Cin, Cout) HWIO bfloat16, ``b`` (Cout,) bfloat16
    or float32 or None, all contiguous on one CUDA device, Cin and Cout in
    1..512 -> (N, H, W, Cout) bfloat16: f32 sums of the exact products, the
    bias and ReLU in f32, one rounding; by the template
    :func:`launch_plan_bf16` picks (``conv3x3_reflect_bf16.by_template``
    counts the launches by its name). ``top``, ``bot``: (N, 1, W, Cin)
    bfloat16 CUDA rows, each image's row contiguous, on any card, or None,
    as :func:`conv3x3_reflect` takes them; the staging of the template's
    halo instantiation reads them in place (counted in
    ``conv3x3_reflect_bf16.halo_launches`` too)."""
    name = "conv3x3_reflect_bf16"
    if x.dim() != 4 or w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"{name}: x {tuple(x.shape)} and HWIO w {tuple(w.shape)} do not match")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if not 1 <= cin <= 512 or not 1 <= cout <= 512:
        raise ValueError(f"{name}: Cin {cin}, Cout {cout} outside 1..512")
    if n > MAX_GRID_Z:
        raise ValueError(f"{name}: batch {n} > {MAX_GRID_Z}")
    bias = () if b is None else (b,)
    if b is not None and b.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: bias must be bfloat16 or float32, got {b.dtype}")
    rows = [t for t in (top, bot) if t is not None]
    _check_cuda(name, x, w, *bias, rows=rows,
                dtype=(torch.bfloat16, torch.bfloat16, *(t.dtype for t in bias)))
    if b is not None and b.shape != (cout,):
        raise ValueError(f"{name}: bias {tuple(b.shape)} != ({cout},)")
    _check_halo(name, x, top, bot)
    y = torch.empty((n, h, wd, cout), device=x.device, dtype=torch.bfloat16)
    if y.numel() == 0:
        return y
    plan = device_plan_bf16(n, h, wd, cin, cout, x.device.index)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream()
        top, bot = reachable(top, x.device, stream), reachable(bot, x.device, stream)
        err = lib.cd_conv3x3_reflect_bf16(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
            ptr(top), ptr(bot), batch_stride(top), batch_stride(bot),
            n, h, wd, cin, cout, int(relu), int(b is not None and b.dtype == torch.bfloat16),
            plan.template, plan.grid[0], int(plan.resident), stream.cuda_stream)
        release(top, x.device, stream)
        release(bot, x.device, stream)
    _build.check(err, name)
    conv3x3_reflect_bf16.launches += 1
    conv3x3_reflect_bf16.halo_launches += bool(rows)
    conv3x3_reflect_bf16.by_template[plan.kernel] += 1
    return y


conv3x3_reflect_bf16.launches = 0
conv3x3_reflect_bf16.halo_launches = 0
conv3x3_reflect_bf16.by_template = Counter()
conv3x3_reflect_bf16.plain = conv3x3_plain


def _refuse_grad(name: str, *tensors: torch.Tensor | None) -> None:
    """A launch records no gradient: while autograd records, an input that
    requires grad is refused (``ops.conv`` launches the kernel inside its
    ``torch.autograd.Function`` for those), so no tensor that needs a
    gradient leaves a kernel without a ``grad_fn``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise ValueError(f"{name}: an input requires grad and the launch records none; "
                         f"call it through ops.conv, whose autograd Function launches it")


def _check_cuda(name: str, *tensors: torch.Tensor, rows=(), dtype=torch.float32) -> None:
    """The kernels take contiguous tensors on one CUDA device, of ``dtype``
    (float32 unless a bf16 kernel says otherwise; a tuple gives one per
    tensor), and no input that requires grad while autograd records;
    ``rows`` (halo rows of another shard) may lie on any CUDA device."""
    _refuse_grad(name, *tensors, *rows)
    dev = tensors[0].device
    for t in rows:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: needs CUDA halo rows, got {t.device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,) * len(tensors)
    for t, want in zip(tensors, dtypes):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: needs CUDA tensors on one device, got "
                             f"{[str(u.device) for u in tensors]}")
        if t.dtype != want:
            raise ValueError(f"{name}: needs {str(want).removeprefix('torch.')}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
