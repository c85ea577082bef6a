"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Marked ``gpu``: they skip where CUDA is absent. On a machine with an H100 run
them from the repository root without the JAX conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import types

import pytest
import torch

from collaborative_distillation_tpu_torch.ops import cuda as kc
from collaborative_distillation_tpu_torch.ops.cuda import conv as kconv
from collaborative_distillation_tpu_torch.ops.wct_transform import (feature_stats, gram_shift,
                                                                    stats_from_sums)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape):
    return torch.rand(shape, generator=gen, device="cuda")


CONV_CASES = [  # (N, H, W, Cin, Cout, relu)
    (1, 16, 16, 3, 24, True), (1, 16, 16, 24, 3, True), (1, 20, 37, 16, 16, True),
    (1, 33, 17, 16, 32, False), (2, 8, 8, 32, 64, True), (1, 8, 8, 64, 128, True),
    (1, 9, 7, 128, 128, True), (1, 4, 4, 128, 64, False), (1, 1, 1, 128, 128, True),
    (1, 1, 6, 64, 32, True), (1, 6, 1, 16, 8, True), (1, 2, 2, 512, 512, True),
    (1, 5, 5, 3, 3, False), (1, 12, 12, 256, 24, True),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv3x3_kernel_matches_plain(gen, case):
    # tolerance: float32 sums of up to 9*512 products in another order,
    # relative to the largest magnitude a partial sum can take
    n, h, w, ci, co, relu = case
    x = _rand(gen, n, h, w, ci)
    wt = (_rand(gen, 3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)
    b = _rand(gen, co) - 0.5
    got = kc.conv3x3_reflect(x, wt, b, relu)
    ref = kc.conv3x3_reflect.plain(x, wt, b, relu)
    torch.cuda.synchronize()
    scale = float(x.abs().max() * wt.abs().sum(dim=(0, 1, 2)).max() + b.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale


# (Cin, Cout) for each template of the launch plan: every ring template at
# the cascade's and the teachers' widths (Cin 256 and Cout 24: a cascade
# template past its Cin), and two of the first kernel's
TEMPLATE_PAIRS = [(128, 128), (64, 128), (128, 64), (32, 64), (16, 32), (32, 32), (24, 24),
                  (3, 24), (16, 16), (3, 16), (32, 16), (16, 3), (24, 3), (256, 24), (5, 7),
                  (256, 512), (129, 64)]
# the teachers' (VGG-19) Cin/Cout pairs at 256 and 512
TEACHER_PAIRS = [(128, 256), (256, 256), (256, 512), (512, 512), (512, 256), (256, 128)]


def _conv3x3_check(gen, n, h, w, ci, co, relu, offset=0):
    """Kernel vs plain on one input (a float offset leaves a contiguous map
    off 16-byte alignment): the error bound of test_conv3x3_kernel_matches_plain,
    and a second call bit-equal to the first."""
    x = _rand(gen, n * h * w * ci + offset)[offset:].view(n, h, w, ci) - 0.5
    wt = (_rand(gen, 3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)
    b = _rand(gen, co) - 0.5
    got = kc.conv3x3_reflect(x, wt, b, relu)
    ref = kc.conv3x3_reflect.plain(x, wt, b, relu)
    again = kc.conv3x3_reflect(x, wt, b, relu)
    torch.cuda.synchronize()
    scale = float(x.abs().max() * wt.abs().sum(dim=(0, 1, 2)).max() + b.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    assert torch.equal(got, again)


@pytest.mark.parametrize("pair", TEMPLATE_PAIRS, ids=str)
@pytest.mark.parametrize("hw", ["1x1", "1x2", "2x1", "2x2", "2x37", "17x9", "tile+1"])
@pytest.mark.parametrize("offset", [0, 1])
def test_conv3x3_templates_at_edge_shapes(gen, pair, hw, offset):
    # H or W of 1 or 2 (reflection onto itself or the neighbour), W not a
    # multiple of the 8-pixel strip, one past the template's tile both ways
    ci, co = pair
    plan = kconv.launch_plan(1, 64, 64, ci, co, 132)
    assert (plan.kernel == "first") == (ci not in kconv.RING_WIDTHS or co not in kconv.RING_WIDTHS)
    h, w = (plan.tile[0] + 1, plan.tile[1] + 1) if hw == "tile+1" else map(int, hw.split("x"))
    _conv3x3_check(gen, 2 if hw == "2x37" else 1, h, w, ci, co, ci % 2 == 0, offset)


@pytest.mark.parametrize("pair", TEACHER_PAIRS, ids=str)
@pytest.mark.parametrize("nhw", [(1, 17, 33), (2, 1, 5), (16, 16, 16), (1, 9, 17)], ids=str)
@pytest.mark.parametrize("offset", [0, 1])
def test_conv3x3_teacher_widths_match_plain(gen, pair, nhw, offset):
    """The Cout-walking ring template at the teachers' widths: ragged maps,
    a map of one row, N = 16 at 16^2 (one wave of work items on 132 SMs) and
    one past the 8 x 16 tile both ways; a ring template plans every pair."""
    ci, co = pair
    n, h, w = nhw
    plan = kconv.launch_plan(n, h, w, ci, co, 132)
    assert plan.kernel != "first" and plan.tiles == (
        n * -(-h // plan.tile[0]) * -(-w // plan.tile[1]) * -(-co // plan.cout_tile))
    _conv3x3_check(gen, n, h, w, ci, co, True, offset)


def _halo_conv_check(gen, n, h, w, ci, co, relu, sides, offset, rows_device="cuda"):
    """The halo conv against its plain version: ``x`` and two neighbour maps
    of other heights, each ``offset`` floats into its buffer; the halo rows
    are views (the upper map's last row, the lower one's first: batch
    strides of their own maps); the error bound of the plain conv check, a
    second call bit-equal, and one halo launch a call."""
    def map_(rows):
        return _rand(gen, n * rows * w * ci + offset)[offset:].view(n, rows, w, ci) - 0.5
    x, up, down = map_(h), map_(3).to(rows_device), map_(2).to(rows_device)
    top = up[:, -1:] if sides in ("both", "top") else None
    bot = down[:, :1] if sides in ("both", "bot") else None
    wt = (_rand(gen, 3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)
    b = _rand(gen, co) - 0.5
    before = kc.conv3x3_reflect.halo_launches
    got = kc.conv3x3_reflect(x, wt, b, relu, top=top, bot=bot)
    again = kc.conv3x3_reflect(x, wt, b, relu, top=top, bot=bot)
    ref = kc.conv3x3_reflect.plain(x, wt, b, relu, top=top, bot=bot)
    torch.cuda.synchronize()
    assert kc.conv3x3_reflect.halo_launches == before + 2
    big = max(float(x.abs().max()), float(up.abs().max()), float(down.abs().max()))
    scale = big * float(wt.abs().sum(dim=(0, 1, 2)).max()) + float(b.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    assert torch.equal(got, again)


@pytest.mark.parametrize("pair", TEMPLATE_PAIRS, ids=str)
@pytest.mark.parametrize("hw", ["1x1", "2x37", "tile+1"])
@pytest.mark.parametrize("sides", ["both", "top", "bot"])
@pytest.mark.parametrize("offset", [0, 1])
def test_conv3x3_halo_rows_at_edge_shapes(gen, pair, hw, sides, offset):
    # every ring template and the first kernel; H = 1 (both rows are halo
    # rows), W = 37 (no multiple of the 8-pixel strip), one past the tile
    # both ways (ragged tiles read no row past ``bot``); a null side
    # reflects; rows off 16-byte alignment take the 4-byte staging
    ci, co = pair
    plan = kconv.launch_plan(1, 64, 64, ci, co, 132)
    h, w = (plan.tile[0] + 1, plan.tile[1] + 1) if hw == "tile+1" else map(int, hw.split("x"))
    _halo_conv_check(gen, 2 if hw == "2x37" else 1, h, w, ci, co, ci % 2 == 0, sides, offset)


@pytest.mark.parametrize("pair", TEMPLATE_PAIRS, ids=str)
@pytest.mark.parametrize("offset", [0, 1])
def test_conv3x3_own_reflection_rows_as_halos_are_bit_equal(gen, pair, offset):
    """The shard's own reflection rows (row 1 and H-2) given as halo rows
    stage the same values in the same order as the kernel without rows: the
    two outputs are bit-equal, so the rows take nothing from the arithmetic
    (HALO false computes what it did before the flag)."""
    ci, co = pair
    n, h, w = 2, 19, 37
    x = _rand(gen, n * h * w * ci + offset)[offset:].view(n, h, w, ci) - 0.5
    wt = (_rand(gen, 3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)
    b = _rand(gen, co) - 0.5
    plain = kc.conv3x3_reflect(x, wt, b, True)
    halo = kc.conv3x3_reflect(x, wt, b, True, top=x[:, 1:2], bot=x[:, -2:-1])
    torch.cuda.synchronize()
    assert torch.equal(plain, halo)


@pytest.mark.parametrize("pair", TEACHER_PAIRS, ids=str)
@pytest.mark.parametrize("sides", ["both", "top", "bot"])
def test_conv3x3_halo_rows_at_teacher_widths(gen, pair, sides):
    ci, co = pair
    _halo_conv_check(gen, 2, 9, 17, ci, co, True, sides, 1 if ci == 256 else 0)


def test_conv3x3_halo_rows_on_other_cards(gen):
    """Rows on other cards: read through the peer pointer (or copied where
    the pair has no peer access), ordered after their producer."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    last = f"cuda:{torch.cuda.device_count() - 1}"
    for ci, co in ((16, 16), (3, 24), (64, 128), (256, 24)):
        _halo_conv_check(gen, 2, 9, 33, ci, co, True, "both", 0, rows_device=last)


def test_per_conv_engine_across_cards_matches_plain():
    """One shard per card: every conv reads its neighbours' rows in place on
    other cards. Run after run the cascade equals the plain one at the
    cascade bar; a producer that reused the rows' memory before the read
    (a missing release edge) showed as 36 dB in some runs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import os

    import numpy as np

    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c, s = d["content"], d["style"]
    n = torch.cuda.device_count()
    spread = WCTEngine(mode="16x", space=4, devices=[f"cuda:{i % n}" for i in range(4)])
    want = WCTEngine(mode="16x").stylize(c, s)
    for _ in range(3):
        mse = float(np.mean((spread.stylize(c, s).astype(np.float64) - want) ** 2))
        assert mse == 0 or 10 * np.log10(1.0 / mse) >= 40.0


SUM_GRAM_CASES = [  # (P, C, shifted, float offset)
    (1000, 24, True, 0), (4097, 128, True, 0), (777, 64, False, 0), (300, 512, False, 0),
    (1, 3, True, 0), (65, 16, True, 0),
    (4194304, 24, True, 0),                        # a stage-1 row count (2048^2)
    (1, 1, True, 0), (1000, 3, False, 0), (999, 5, True, 0),   # odd widths
    (500, 129, True, 0), (2000, 512, True, 0),     # the tiled kernel past 128
    (1, 24, True, 0), (1, 128, False, 0),          # one row
    (301, 24, True, 0), (251, 32, True, 0), (127, 64, False, 0),
    (65, 128, True, 0),                            # one past a staging block
    (1663201, 24, True, 0), (825001, 32, False, 0),    # one past a fold chunk
    (1000, 3, True, 1), (1000, 24, True, 1), (257, 128, False, 3),  # not 16-byte aligned
]


@pytest.mark.parametrize("case", SUM_GRAM_CASES, ids=str)
def test_sum_gram_kernel_matches_plain(gen, case):
    # tolerance: float32 sums over P rows in another order; an offset of 1
    # or 3 floats leaves a contiguous matrix that is not 16-byte aligned
    p, c, shifted, offset = case
    x = (_rand(gen, p * c + offset) * 4 + 10)[offset:].view(p, c)
    shift = x[:64].mean(0) if shifted else None
    (s, g), (sp, gp) = kc.sum_gram(x, shift), kc.sum_gram.plain(x, shift)
    torch.cuda.synchronize()
    assert float((g - gp).abs().max()) <= 2e-5 * float(gp.abs().max())
    xs = x if shift is None else x - shift
    assert float((s - sp).abs().max()) <= 2e-5 * float(xs.abs().sum(0).max())
    s2, g2 = kc.sum_gram(x, shift)
    assert torch.equal(s, s2) and torch.equal(g, g2)  # fixed-order reduction


def test_sum_gram_covariance_of_8m_rows_matches_float64(gen):
    # 8M x 24 (mean 10, spread 4): the shifted Gram's covariance within
    # 2e-5 of max|cov| in float64; a serial chain over millions of rows
    # would not hold it
    p = 8 << 20
    x = _rand(gen, p, 24) * 4 + 10
    shift = gram_shift(x)
    mean, cov = stats_from_sums(shift, *kc.sum_gram(x, shift), p)
    x64 = x.double()
    m64 = x64.mean(0)
    cov64 = ((x64 - m64).T @ (x64 - m64)) / (p - 1)
    assert float((cov.double() - cov64).abs().max()) <= 2e-5 * float(cov64.abs().max())
    assert float((mean.double() - m64).abs().max()) <= 2e-5 * float(m64.abs().max())


@pytest.mark.parametrize("shape", [(1, 8, 8, 16), (1, 7, 9, 16), (2, 5, 4, 3),
                                   (1, 2, 2, 128), (1, 1, 4, 8)], ids=str)
@pytest.mark.parametrize("aligned", [True, False])
def test_pool_and_upsample_kernels_are_exact(gen, shape, aligned):
    n = 1
    for d in shape:
        n *= d
    buf = _rand(gen, n + 1)
    # an offset of one float leaves a contiguous map that is not 16-byte
    # aligned: the kernels must take their scalar path
    x = (buf[:n] if aligned else buf[1:]).view(shape)
    assert torch.equal(kc.max_pool_2x2(x), kc.max_pool_2x2.plain(x))
    assert torch.equal(kc.upsample_nearest_2x(x), kc.upsample_nearest_2x.plain(x))


CONV1X1_CASES = [  # (P, Cin, Cout, relu, bias, offset)
    (4096, 24, 24, False, True, 0), (4096, 128, 128, False, True, 0),
    (1000, 32, 64, True, True, 0), (777, 64, 128, True, False, 0),
    (1, 8, 8, False, True, 0), (1, 128, 3, True, True, 0), (65, 3, 24, True, True, 0),
    (300, 24, 128, False, True, 1), (129, 128, 24, False, True, 3),
    (5000, 12, 8, True, False, 0),
    # one past a pixel tile of each Cout class (256, 256, 256, 128 pixels),
    # off 16-byte alignment, and many tiles per block (the ring wraps)
    (257, 24, 24, False, True, 1), (257, 32, 32, True, True, 2), (257, 64, 64, False, True, 3),
    (129, 128, 128, False, True, 1), (300001, 24, 24, False, True, 0),
    (300001, 32, 32, False, True, 1), (100003, 64, 64, True, True, 0),
    (100003, 128, 128, False, True, 2), (1, 24, 24, False, True, 0),
]


@pytest.mark.parametrize("case", CONV1X1_CASES, ids=str)
def test_conv1x1_kernel_matches_plain(gen, case):
    # tolerance: float32 sums of up to 128 products in another order, relative
    # to the largest magnitude a partial sum can take; an offset of 1 or 3
    # floats leaves a contiguous map that is not 16-byte aligned
    p, ci, co, relu, bias, offset = case
    buf = _rand(gen, p * ci + offset) - 0.5
    x = buf[offset:].view(p, ci)
    w = (_rand(gen, ci, co) - 0.5) * (2 / ci ** 0.5)
    b = _rand(gen, co) - 0.5 if bias else None
    got, ref = kc.conv1x1_bias(x, w, b, relu), kc.conv1x1_bias.plain(x, w, b, relu)
    torch.cuda.synchronize()
    scale = float(x.abs().max() * w.abs().sum(0).max() + (b.abs().max() if bias else 0))
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    assert torch.equal(got, kc.conv1x1_bias(x, w, b, relu))   # repeat calls bit-equal


def test_kernels_keep_nan_as_torch_does(gen):
    """A NaN input stays NaN through ReLU and max pool, as in torch and the
    reference (a one-pixel covariance makes a whole cascade NaN)."""
    x = _rand(gen, 1, 6, 6, 8) - 0.5
    x[0, 2, 3, 1] = float("nan")
    w3 = _rand(gen, 3, 3, 8, 8) - 0.5
    w1 = _rand(gen, 8, 8) - 0.5
    b = torch.zeros(8, device="cuda")
    for got, ref in [(kc.max_pool_2x2(x), kc.max_pool_2x2.plain(x)),
                     (kc.conv3x3_reflect(x, w3, b, True), kc.conv3x3_reflect.plain(x, w3, b, True)),
                     (kc.conv1x1_bias(x, w1, b, True), kc.conv1x1_bias.plain(x, w1, b, True))]:
        assert torch.equal(got.isnan(), ref.isnan()) and bool(got.isnan().any())


@pytest.mark.parametrize("pair", TEMPLATE_PAIRS + TEACHER_PAIRS, ids=str)
def test_conv3x3_templates_keep_nan(gen, pair):
    # one NaN input pixel in the middle of a tile and one on the map's edge
    # (read again by the reflection): NaN where the plain version has it
    ci, co = pair
    x = _rand(gen, 1, 40, 70, ci) - 0.5
    x[0, 20, 30, 0] = float("nan")
    x[0, 0, 69, ci - 1] = float("nan")
    wt = _rand(gen, 3, 3, ci, co) - 0.5
    b = _rand(gen, co) - 0.5
    got, ref = kc.conv3x3_reflect(x, wt, b, True), kc.conv3x3_reflect.plain(x, wt, b, True)
    assert torch.equal(got.isnan(), ref.isnan()) and bool(got.isnan().any())


def test_slab_engine_on_card_matches_cpu():
    """The slab engine on the card against the same engine on the CPU at
    512^2 (slab_rows=288: one window at stage 5, whose margins of 144 do not
    fit twice, two at stages 4..1, the second shifted up to end at the
    image): the same float32 math in other orders, held to the cascade bar
    of 40 dB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    import numpy as np

    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c, s = d["content"], d["style"]
    before = kc.conv1x1_bias.launches
    card = WCTEngine(mode="16x", slab_rows=288).stylize(c, s)
    assert kc.conv1x1_bias.launches - before == 1 + 4 * 2   # one per window and stage
    cpu = WCTEngine(mode="16x", slab_rows=288, device="cpu").stylize(c, s)
    mse = float(np.mean((card.astype(np.float64) - cpu) ** 2))
    assert 10 * np.log10(1.0 / mse) >= 40.0


HALO_CASES = [  # (N, H, W, C, hm, float offset of the shard, sides)
    (1, 8, 16, 8, 2, 0, "both"), (1, 8, 16, 8, 8, 0, "both"), (2, 8, 16, 8, 1, 0, "both"),
    (1, 6, 5, 3, 2, 0, "both"), (2, 6, 5, 3, 3, 1, "both"), (1, 4, 7, 1, 1, 3, "both"),
    (1, 16, 64, 3, 4, 0, "top"), (1, 16, 64, 3, 4, 0, "bot"), (2, 5, 9, 2, 5, 0, "none"),
]


@pytest.mark.parametrize("case", HALO_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8], ids=str)
def test_halo_kernel_equals_plain(gen, case, dtype):
    """A copy: exact at every shape, with 16-byte, 4-byte and 1-byte units
    (odd row sizes, a shard and neighbours that start at an odd offset)."""
    n, h, w, c, hm, offset, sides = case

    def shard():
        buf = (_rand(gen, n * h * w * c + offset) * 200).to(dtype)
        return buf[offset:].view(n, h, w, c)

    x, up, down = shard(), shard(), shard()
    top = up[:, -hm:] if sides in ("both", "top") else None
    bot = down[:, :hm] if sides in ("both", "bot") else None
    before = kc.halo_exchange_rows.launches
    got = kc.halo_exchange_rows(x, top, bot, hm)
    torch.cuda.synchronize()
    assert kc.halo_exchange_rows.launches == before + 1
    assert torch.equal(got, kc.halo_exchange_rows.plain(x, top, bot, hm))


def test_halo_kernel_takes_the_shards_own_rows_and_refuses_strided_ones(gen):
    x = _rand(gen, 2, 6, 5, 3)
    got = kc.halo_exchange_rows(x, x[:, 1:2], x[:, -2:-1], 1)   # the reflection rows
    assert torch.equal(got, kc.halo_exchange_rows.plain(x, x[:, 1:2], x[:, -2:-1], 1))
    with pytest.raises(ValueError, match="contiguous"):
        kc.halo_exchange_rows(x.permute(0, 2, 1, 3), None, None, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kc.halo_exchange_rows(x, _rand(gen, 2, 2, 3, 5).permute(0, 1, 3, 2), None, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kc.halo_exchange_rows(x, x[:, :1].cpu(), None, 1)


FILL_CASES = [  # (N, H, W, C, hm, float offset of the sources, sides)
    (1, 8, 16, 8, 2, 0, "both"), (2, 8, 16, 8, 1, 0, "both"), (1, 6, 5, 3, 2, 1, "both"),
    (2, 6, 5, 3, 3, 3, "both"), (1, 4, 7, 1, 1, 0, "top"), (2, 5, 9, 2, 5, 2, "bot"),
    (1, 16, 64, 3, 4, 0, "none"), (2, 64, 1024, 3, 32, 0, "both"),
]


def _fill_inputs(gen, n, h, w, c, hm, offset, dtype, shards=3):
    """``shards`` extended shards (N, H + 2*hm, W, C) with written interiors
    and garbage halos, and per shard the (top, bot) interior rows of its
    neighbours: views into other maps, ``offset`` elements into buffers."""
    def buf(rows, at):
        per = rows * w * c
        return (_rand(gen, n * per + at) * 200).to(dtype)[at:].view(n, rows, w, c)

    exts = [buf(h + 2 * hm, 0) for _ in range(shards)]
    nbrs = [buf(h, offset) for _ in range(2)]
    return exts, nbrs[0][:, -hm:], nbrs[1][:, :hm]


@pytest.mark.parametrize("case", FILL_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8], ids=str)
def test_halo_fill_kernel_equals_plain(gen, case, dtype):
    """The fill of three extended shards in one launch: exactly its plain
    version (16-, 4- and 1-byte units: odd row sizes, sources at odd
    offsets, N = 2 batch strides, null sources), the interiors untouched."""
    n, h, w, c, hm, offset, sides = case
    exts, up, down = _fill_inputs(gen, n, h, w, c, hm, offset, dtype)
    top = up if sides in ("both", "top") else None
    bot = down if sides in ("both", "bot") else None
    items = [(e, top, bot) for e in exts]
    want = [e.clone() for e in exts]
    kc.halo_fill_rows.plain([(e, top, bot) for e in want], hm)
    inner = [e[:, hm:hm + h].clone() for e in exts]
    before = kc.halo_fill_rows.launches
    kc.halo_fill_rows(items, hm)
    torch.cuda.synchronize()
    assert kc.halo_fill_rows.launches == before + 1
    for e, ref, x in zip(exts, want, inner):
        assert torch.equal(e, ref) and torch.equal(e[:, hm:hm + h], x)


@pytest.mark.parametrize("case", HALO_CASES[:6] + [(2, 64, 1024, 3, 32, 0, "both")], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8], ids=str)
def test_halo_exchange_of_several_shards_in_one_launch(gen, case, dtype):
    """``halo_exchange_rows_many``: three shards of one card (one of other
    rows) in one launch, each equal to the plain exchange."""
    n, h, w, c, hm, offset, _ = case

    def shard(rows):
        buf = (_rand(gen, n * rows * w * c + offset) * 200).to(dtype)
        return buf[offset:].view(n, rows, w, c)

    xs = [shard(h), shard(h + 3), shard(h)]
    items = [(xs[0], None, xs[1][:, :hm]), (xs[1], xs[0][:, -hm:], xs[2][:, :hm]),
             (xs[2], xs[1][:, -hm:], None)]
    before = kc.halo_exchange_rows.launches
    got = kc.halo_exchange_rows_many(items, hm)
    torch.cuda.synchronize()
    assert kc.halo_exchange_rows.launches == before + 1
    for g, item in zip(got, items):
        assert torch.equal(g, kc.halo_exchange_rows.plain(*item, hm))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8], ids=str)
def test_halo_tables_longer_than_one_launch(gen, dtype):
    """Twelve shards of one card are 36 exchange and 24 fill segments: the
    library splits the exchange's table into two launches and takes the
    fill's in one, each shard exactly its plain version."""
    n, h, w, c, hm = 2, 9, 33, 3, 2
    xs = [(_rand(gen, n, h, w, c) * 200).to(dtype) for _ in range(12)]
    items = [(x, xs[i - 1][:, -hm:] if i else None, xs[i + 1][:, :hm] if i < 11 else None)
             for i, x in enumerate(xs)]
    before = (kc.halo_exchange_rows.launches, kc.halo_fill_rows.launches)
    got = kc.halo_exchange_rows_many(items, hm)
    exts = [g.clone() for g in got]
    for e in exts:
        e[:, :hm] = 7
        e[:, -hm:] = 7
    kc.halo_fill_rows([(e, *it[1:]) for e, it in zip(exts, items)], hm)
    torch.cuda.synchronize()
    assert (kc.halo_exchange_rows.launches - before[0],
            kc.halo_fill_rows.launches - before[1]) == (2, 1)
    for g, e, item in zip(got, exts, items):
        want = kc.halo_exchange_rows.plain(*item, hm)
        assert torch.equal(g, want) and torch.equal(e, want)


def test_halo_fill_refusals(gen):
    ext = _rand(gen, 1, 8, 5, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kc.halo_fill_rows([(ext, None, None), (ext.cpu(), None, None)], 2)
    with pytest.raises(ValueError, match="contiguous"):
        kc.halo_fill_rows([(ext.permute(0, 2, 1, 3), None, None)], 1)
    with pytest.raises(ValueError, match="no room"):
        kc.halo_fill_rows([(ext, None, None)], 5)
    g = ext.clone().requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        kc.halo_fill_rows([(g, None, None)], 2)


def test_sharded_engines_on_one_card_match_single_device():
    """Four row shards on cuda:0: the slab-in-shard cascade against the
    single-card slab engine at the same slab size (global slab boundaries
    coincide; float32 order only), and the per-conv cascade against the plain
    engine, both at the cascade bar of 40 dB; one exchange and four fills
    for the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    import numpy as np

    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c, s = d["content"], d["style"]
    tall = np.concatenate([c, c[::-1], c])[:1152, :128]   # 4 shards x one 288-row slab

    def psnr(a, b):
        mse = float(np.mean((a.astype(np.float64) - b) ** 2))
        return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)

    before = (kc.halo_exchange_rows.launches, kc.halo_fill_rows.launches)
    sharded = WCTEngine(mode="16x", space=4, slab_rows=288, devices=["cuda:0"] * 4).stylize(tall, s)
    # one card: one exchange at stage 5, one fill before each later stage
    assert (kc.halo_exchange_rows.launches - before[0],
            kc.halo_fill_rows.launches - before[1]) == (1, 4)
    assert psnr(sharded, WCTEngine(mode="16x", slab_rows=288).stylize(tall, s)) >= 40.0
    before = (kc.halo_exchange_rows.launches, kc.conv3x3_reflect.halo_launches)
    per_conv = WCTEngine(mode="16x", space=4, devices=["cuda:0"] * 4).stylize(c, s)
    assert kc.halo_exchange_rows.launches == before[0]   # the conv reads its halos itself
    assert kc.conv3x3_reflect.halo_launches - before[1] == 4 * 62
    assert psnr(per_conv, WCTEngine(mode="16x").stylize(c, s)) >= 40.0
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="needs 4 devices"):
            WCTEngine(mode="16x", space=4, slab_rows=288)


def test_launch_counts_and_refusals(gen):
    x = _rand(gen, 1, 4, 4, 8)
    before = kc.max_pool_2x2.launches
    kc.max_pool_2x2(x)
    assert kc.max_pool_2x2.launches == before + 1
    with pytest.raises(ValueError):
        kc.max_pool_2x2(x.double())
    with pytest.raises(ValueError):
        kc.max_pool_2x2(x.permute(0, 2, 1, 3))  # not contiguous
    with pytest.raises(ValueError):
        kc.conv3x3_reflect(x, torch.zeros(3, 3, 8, 4, device="cuda"),
                           torch.zeros(4), True)  # bias on the CPU


def test_feature_stats_on_card_matches_float64(gen):
    x = _rand(gen, 300, 200, 24) * 3 + 50
    mean, cov = feature_stats(x)
    x64 = x.reshape(-1, 24).double()
    m64 = x64.mean(0)
    cov64 = (x64 - m64).T @ (x64 - m64) / (x64.shape[0] - 1)
    assert float((cov.double() - cov64).abs().max()) <= 1e-4 * float(cov64.abs().max())
    assert float((mean.double() - m64).abs().max()) <= 1e-5 * float(m64.abs().max())


@pytest.mark.parametrize("shape,dtype", [((2048, 2048, 3), torch.uint8),
                                         ((1001, 7), torch.float32), ((5,), torch.uint8)],
                         ids=str)
def test_push_and_fetch_round_trip_on_a_side_stream(gen, shape, dtype):
    """push through pinned staging in chunks smaller than the array, read
    at once on a stream that is not the default one, and fetch back."""
    import numpy as np

    from collaborative_distillation_tpu_torch.utils.transfer import fetch, push
    a = (torch.rand(shape, generator=torch.Generator().manual_seed(1)) * 200).to(dtype).numpy()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        x = push(a, "cuda", chunk_bytes=1 << 20)
        y = x * 1   # queued on s, after the copies
    s.synchronize()
    assert x.device.type == "cuda" and torch.equal(y.cpu(), torch.from_numpy(a))
    np.testing.assert_array_equal(fetch(x), a)


def test_host_boundary_on_card_matches_cpu():
    """The streamed planes, the yuv420 transport and stylize_pairs on the
    card: the planes and transport against the CPU engine at the cascade
    bar (40 dB), stylize_pairs bit-equal to serial calls on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    import numpy as np

    from collaborative_distillation_tpu_torch.data import native_codec as nc
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c, s = d["content"], d["style"]
    tall = np.ascontiguousarray(np.concatenate([c, c[::-1]])[:800, :256])

    def psnr(a, b):
        mse = float(np.mean((a.astype(np.float64) - b) ** 2))
        return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)

    card = WCTEngine(mode="16x", slab_rows=288, stream_min_pix=1)
    cpu = WCTEngine(mode="16x", slab_rows=288, device="cpu")
    if nc.available():
        y, cbcr = nc.rgb_to_yuv420(tall)
        for a, b in zip(card.stylize_planes(y, cbcr, s), cpu.stylize_planes(y, cbcr, s)):
            assert a.shape == b.shape and psnr(a, b) >= 40.0
    assert psnr(card.stylize(tall, s, as_uint8=True, transport="yuv420"),
                cpu.stylize(tall, s, as_uint8=True, transport="yuv420")) >= 40.0
    plain = WCTEngine(mode="16x")
    pairs = [(c, s), (np.ascontiguousarray(c[::-1]), s), (c[:200, :300], s[:64, :64])]
    serial = [plain.stylize(a, b, as_uint8=True) for a, b in pairs]
    for got, want in zip(plain.stylize_pairs(pairs), serial):
        np.testing.assert_array_equal(got, want)


GRAD_CASES = [  # (N, H, W, Cin, Cout): student and teacher widths, odd and 1-pixel maps
    (2, 16, 16, 3, 16), (2, 8, 8, 64, 128), (1, 4, 4, 512, 512), (2, 7, 9, 24, 32),
    (1, 1, 1, 16, 16), (1, 1, 5, 3, 3)]


@pytest.mark.parametrize("case", GRAD_CASES, ids=str)
def test_autograd_functions_match_plain_on_card(gen, case):
    """The kernels' Functions against the plain versions, forward and own
    autograd, TF32 off: conv3x3 to 1e-5 of the largest partial sum, pool and
    upsample exactly."""
    from collaborative_distillation_tpu_torch.ops import conv as tconv
    from collaborative_distillation_tpu_torch.train.trainer import full_float32
    n, h, w, ci, co = case
    x = _rand(gen, n, h, w, ci).requires_grad_()
    wt = ((_rand(gen, 3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)).requires_grad_()
    b = (_rand(gen, co) - 0.5).requires_grad_()
    g = _rand(gen, n, h, w, co) - 0.5
    with full_float32():
        y = tconv.conv3x3(x, wt, b, relu=False)
        got = torch.autograd.grad(y, (x, wt, b), g)
        plain = kc.conv3x3_reflect.plain(x, wt, b, False)
        want = torch.autograd.grad(plain, (x, wt, b), g)
        with torch.no_grad():
            fscale = float(x.abs().max() * wt.abs().sum(dim=(0, 1, 2)).max() + b.abs().max())
            assert float((y - plain).abs().max()) <= 1e-5 * fscale
        # the largest magnitude a partial sum of each gradient can take
        ab = [t.detach().abs().requires_grad_() for t in (x, wt, b)]
        scale = torch.autograd.grad(kc.conv3x3_reflect.plain(*ab, False), ab, g.abs())
    for a, r, s in zip(got, want, scale):
        assert float((a - r).abs().max()) <= 1e-5 * float(s.abs().max())
    xi = torch.floor(_rand(gen, n, 2 * max(h, 1), 2 * max(w, 1), ci) * 3).requires_grad_()
    gp = torch.floor(_rand(gen, n, max(h, 1), max(w, 1), ci) * 7) - 3
    pooled = tconv.max_pool_2x2(xi)
    got = torch.autograd.grad(pooled, xi, gp)[0]
    want = torch.autograd.grad(torch.nn.functional.max_pool2d(
        xi.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1), xi, gp)[0]
    assert torch.equal(got, want)
    assert torch.equal(pooled, kc.max_pool_2x2.plain(xi.detach()))
    y = tconv.upsample_nearest_2x(x)
    up = torch.autograd.grad(y, x, torch.ones(n, 2 * h, 2 * w, ci, device="cuda"))[0]
    assert torch.equal(up, torch.full_like(x, 4.0))
    assert torch.equal(y, kc.upsample_nearest_2x.plain(x.detach()))


@pytest.mark.parametrize("case", [(2, 16, 16, 512, 512), (1, 9, 17, 256, 512),
                                  (2, 8, 8, 512, 256)], ids=str)
def test_conv3x3_function_gradients_at_teacher_widths(gen, case):
    """The ``Conv3x3`` Function with ReLU at the teachers' widths against the
    plain version's autograd under the kernel's own ReLU decisions (as
    chip_smoke.py phase 8a holds them): a pre-activation within rounding of
    0 may take the other side in the plain forward, so the plain gradient
    takes the kernel's mask; each gradient to 1e-5 of its largest partial sum."""
    from collaborative_distillation_tpu_torch.ops import conv as tconv
    from collaborative_distillation_tpu_torch.train.trainer import full_float32
    n, h, w, ci, co = case
    x = _rand(gen, n, h, w, ci).requires_grad_()
    wt = ((_rand(gen, 3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)).requires_grad_()
    b = (_rand(gen, co) - 0.5).requires_grad_()
    g = _rand(gen, n, h, w, co) - 0.5
    with full_float32():
        y = tconv.conv3x3(x, wt, b, relu=True)
        got = torch.autograd.grad(y, (x, wt, b), g)
        with torch.no_grad():
            pre = kc.conv3x3_reflect(x, wt, b, False)
            plain = kc.conv3x3_reflect.plain(x, wt, b, False)
            fscale = float(x.abs().max() * wt.abs().sum(dim=(0, 1, 2)).max() + b.abs().max())
            assert float((y - plain.clamp_min(0)).abs().max()) <= 1e-5 * fscale
            assert float((pre - plain).abs().max()) <= 1e-5 * fscale
            assert int(((pre > 0) != (plain > 0)).sum()) <= max(2, 1e-5 * pre.numel())
            gp = g * torch.where(pre > 0, 1.0, torch.where(pre == 0, 0.5, 0.0))
        want = torch.autograd.grad(kc.conv3x3_reflect.plain(x, wt, b, False), (x, wt, b), gp)
        ab = [t.detach().abs().requires_grad_() for t in (x, wt, b)]
        scale = torch.autograd.grad(kc.conv3x3_reflect.plain(*ab, False), ab, g.abs())
    for a, r, sc in zip(got, want, scale):
        assert float((a - r).abs().max()) <= 1e-5 * float(sc.abs().max())


def test_relu_tie_on_card_is_half_the_gradient(gen):
    from collaborative_distillation_tpu_torch.ops import conv as tconv
    x = _rand(gen, 1, 8, 8, 16)
    w = torch.zeros(3, 3, 16, 32, device="cuda", requires_grad=True)
    b = torch.zeros(32, device="cuda", requires_grad=True)
    g = _rand(gen, 1, 8, 8, 32)
    y = tconv.conv3x3(x, w, b, relu=True)
    assert y.grad_fn is not None
    y.backward(g)
    assert torch.equal(b.grad, 0.5 * g.sum(dim=(0, 1, 2)))


def test_trainer_step_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    from collaborative_distillation_tpu_torch.models.vgg import init_params
    from collaborative_distillation_tpu_torch.train.trainer import TrainConfig, Trainer
    k = 2
    gen = torch.Generator().manual_seed(0)
    frozen = {"be": init_params(encoder_spec("original", k), gen),
              "bd": init_params(decoder_spec("original", k), gen)}
    student = init_params(encoder_spec("16x", k, aux=True), gen)
    batch = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    cfg = TrainConfig(mode="wct_se", stage=k)
    card, cpu = (Trainer(cfg, student, frozen, device=d) for d in ("cuda", "cpu"))
    p0 = {name: {kind: t.detach().clone() for kind, t in leaf.items()}
          for name, leaf in cpu.params.items()}
    lc, _ = card.train_step(batch)
    lp, _ = cpu.train_step(batch)
    for name in lp:
        assert abs(float(lc[name]) - float(lp[name])) <= 1e-5 * abs(float(lp[name]))
    for name, leaf in cpu.params.items():
        for kind, t in leaf.items():
            g = t.grad
            gc = card.params[name][kind].grad.cpu()
            assert float((gc - g).abs().max()) <= 1e-4 * float(g.abs().max()), (name, kind)
            # Adam's first update is lr * g / (|g| + eps): where |g| is over
            # 1e-3 of the leaf's max, the card's within 1e-3 lr of the CPU's;
            # a component nearer 0 may step the other way (2 lr)
            du = card.params[name][kind].detach().cpu() - t.detach()
            strong = g.abs() >= 1e-3 * g.abs().max()
            assert float(du.abs().max()) <= 2 * cfg.lr, (name, kind)
            assert float(du[strong].abs().max()) <= 1e-3 * cfg.lr, (name, kind)


@pytest.mark.parametrize("rows", [(16, 16, 16, 32), (1, 1, 1, 2), (3, 3, 3, 5)], ids=str)
def test_halo_kernel_at_unequal_shard_heights(gen, rows):
    """The per-conv sharded path deals whole 16-row blocks, the remainder to
    the last shards: shards of unequal heights, one row each at stage 5.
    Every shard's halo pair is its neighbours' rows (its own reflection,
    None, at a global edge of a shard of 2+ rows; the opposite neighbour's
    for one row); the halo kernel of the slab path extends each shard with
    the pair filled in exactly as its plain version; the conv on the pairs
    joined equals the unsharded conv."""
    from collaborative_distillation_tpu_torch.parallel import spatial as tsp
    shards = [_rand(gen, 1, h, 37, 16) for h in rows]
    pairs = tsp.halo_rows(shards)
    for d, (x, (top, bot)) in enumerate(zip(shards, pairs)):
        want_top = shards[d - 1][:, -1:] if d else (None if x.shape[1] > 1 else shards[1][:, :1])
        want_bot = (shards[d + 1][:, :1] if d < len(rows) - 1 else
                    (None if x.shape[1] > 1 else shards[d - 1][:, -1:]))
        for got, want in ((top, want_top), (bot, want_bot)):
            assert got is None if want is None else torch.equal(got, want)
        top = x[:, 1:2] if top is None else top
        bot = x[:, -2:-1] if bot is None else bot
        assert torch.equal(kc.halo_exchange_rows(x, top, bot, 1),
                           kc.halo_exchange_rows.plain(x, top, bot, 1))
    wt = (_rand(gen, 3, 3, 16, 16) - 0.5) * 0.2
    b = _rand(gen, 16) - 0.5
    got = torch.cat(tsp.conv3x3_halo(shards, [wt] * len(rows), [b] * len(rows)), dim=1)
    whole = kc.conv3x3_reflect.plain(torch.cat(shards, dim=1), wt, b, True)
    torch.cuda.synchronize()
    assert float((got - whole).abs().max()) <= 1e-5 * float(wt.abs().sum(dim=(0, 1, 2)).max()
                                                            + b.abs().max())


@pytest.mark.parametrize("shape", [(1, 32, 48, 128, 128), (1, 64, 40, 64, 64),
                                   (1, 130, 66, 16, 16), (1, 34, 18, 32, 32)], ids=str)
def test_conv3x3_on_an_unpooled_map(gen, shape):
    """Photo-WCT's decoder convs read max-unpooled maps: three of every four
    values exactly 0 (an odd size zero-filled at the edge)."""
    from collaborative_distillation_tpu_torch.ops.conv import (max_pool_2x2_with_argmax,
                                                                max_unpool_2x2)
    n, h, w, ci, co = shape
    x0 = _rand(gen, n, h, w, ci) - 0.5
    pooled, idx = max_pool_2x2_with_argmax(x0)
    assert torch.equal(pooled, kc.max_pool_2x2(x0))   # the pool kernel's maxima, bit for bit
    x = max_unpool_2x2(pooled, idx, (h + 1, w + 1))
    wt = (_rand(gen, 3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)
    b = _rand(gen, co) - 0.5
    got = kc.conv3x3_reflect(x, wt, b, True)
    ref = kc.conv3x3_reflect.plain(x, wt, b, True)
    torch.cuda.synchronize()
    scale = float(x.abs().max() * wt.abs().sum(dim=(0, 1, 2)).max() + b.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale


# ---- nvJPEG on the card, against libjpeg's decodes in the fixture ---------------------
# (collaborative_distillation_tpu_torch/data/jpeg_fixture.npz, made on a host with
# libjpeg by tools/make_jpeg_fixture.py; the card's machine has no libjpeg)

JPEG_FIXTURE_FILES = ["in1", "c444", "prog", "odd", "grey"]


@pytest.fixture(scope="module")
def jfix():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    import numpy as np
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "collaborative_distillation_tpu_torch", "data",
                              "jpeg_fixture.npz")) as d:
        return {k: d[k] for k in d.files}


def _psnr_u8(a, b) -> float:
    import numpy as np
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def test_nvjpeg_loads_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    assert nj.available(), nj.unavailable_reason()
    assert nj.unavailable_reason() is None and nj.version()


def test_nvjpeg_decode_planes_match_libjpeg(jfix):
    """The file's own 4:2:0 planes: both decoders dequantize the same
    coefficients, and only their IDCTs' rounding differs (nvJPEG's is not
    libjpeg's JDCT_ISLOW): at most 1 level, mean under 0.05 (read on an
    H100: 1 and 0.016 on Y, 1 and 0.014 on CbCr)."""
    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    y, cbcr = nj.decode_jpeg_yuv420(jfix["in1_jpeg"].tobytes())
    for got, want in ((y, jfix["in1_y"]), (cbcr, jfix["in1_cbcr"])):
        d = (got.cpu().numpy().astype(int) - want).__abs__()
        assert got.shape == want.shape and got.dtype == torch.uint8
        assert d.max() <= 1 and d.mean() <= 0.05, (d.max(), d.mean())


@pytest.mark.parametrize("name", JPEG_FIXTURE_FILES)
def test_nvjpeg_decode_rgb_matches_libjpeg(jfix, name):
    """RGB of every sampling and kind (4:4:4, progressive, odd-sized, grey):
    nvJPEG's chroma upsampling is not libjpeg's fancy one, so the bar is
    40 dB, not a level count."""
    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    got = nj.decode_jpeg(jfix[f"{name}_jpeg"].tobytes())
    want = jfix[f"{name}_rgb"]
    assert got is not None and tuple(got.shape) == want.shape
    assert _psnr_u8(got.cpu().numpy(), want) >= 40.0


def test_nvjpeg_encode_tables_and_round_trip(jfix):
    """nvJPEG's quality-95 stream carries the IJG tables of quality 95, and
    its round trip is within 40 dB of the planes, as libjpeg's own q95 file
    of the same planes is when nvJPEG decodes it."""
    from collaborative_distillation_tpu_torch.data import jpeg_header
    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    y = torch.from_numpy(jfix["content_y"]).cuda()
    cbcr = torch.from_numpy(jfix["content_cbcr"]).cuda()
    body = nj.encode_jpeg_yuv420(y, cbcr, quality=95)
    hdr = jpeg_header.parse(body)
    assert hdr.planes_ok and (hdr.width, hdr.height) == (512, 512)
    lum, chrom = jpeg_header.ijg_quant_tables(95)
    tables = [hdr.quant_tables[c.tq] for c in hdr.components]
    assert (tables[0] == lum).all() and (tables[1] == chrom).all() and (tables[2] == chrom).all()
    for data in (body, jfix["content_q95"].tobytes()):
        yo, co = nj.decode_jpeg_yuv420(data)
        assert _psnr_u8(yo.cpu().numpy(), jfix["content_y"]) >= 40.0
        assert _psnr_u8(co.cpu().numpy(), jfix["content_cbcr"]) >= 40.0


def test_nvjpeg_encode_rgb_at_odd_sizes(jfix):
    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    rgb = jfix["in1_rgb"][:125, :127]
    body = nj.encode_jpeg(torch.from_numpy(rgb.copy()).cuda(), quality=95)
    got = nj.decode_jpeg(body)
    assert tuple(got.shape) == rgb.shape and _psnr_u8(got.cpu().numpy(), rgb) >= 35.0
    cut = nj.decode_jpeg(body[:len(body) // 2])   # a cut file: None, or gaps filled
    assert cut is None or tuple(cut.shape) == rgb.shape
    assert nj.decode_jpeg(b"\xff\xd8\xff\xdb") is None
    assert nj.encode_jpeg_yuv420(torch.zeros(3, 4, dtype=torch.uint8, device="cuda"),
                                 torch.zeros(1, 2, 2, dtype=torch.uint8, device="cuda")) is None


def test_nvjpeg_threads_share_no_state(jfix):
    """Decodes and encodes from four threads at once equal serial ones."""
    from concurrent.futures import ThreadPoolExecutor

    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    data = [jfix[f"{n}_jpeg"].tobytes() for n in JPEG_FIXTURE_FILES] * 2

    def work(b):
        rgb = nj.decode_jpeg(b)
        return rgb.cpu(), nj.encode_jpeg(rgb)

    serial = [work(b) for b in data]
    with ThreadPoolExecutor(4) as pool:
        for (a, ab), (b, bb) in zip(pool.map(work, data), serial):
            assert torch.equal(a, b) and ab == bb
    mem = nj.memory()
    assert mem["device"] > 0 and mem["pinned"] > 0


def test_stylize_jpeg_on_card_equals_planes_plus_encode(jfix):
    """On the card the JPEG endpoints decode and encode with nvJPEG: their
    bytes equal stylize_planes(on_device=True) + encode_jpeg_yuv420, and the
    None contract holds for files the planes path does not take."""
    import numpy as np

    from collaborative_distillation_tpu_torch.data import nvjpeg_codec as nj
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    content = np.concatenate([jfix["in1_rgb"], jfix["in1_rgb"][::-1]])[:704, :128]
    data = nj.encode_jpeg(torch.from_numpy(np.ascontiguousarray(content)).cuda())
    y, cbcr = nj.decode_jpeg_yuv420(data)
    style = jfix["in1_rgb"][:64, :64]
    eng = WCTEngine(mode="16x", slab_rows=288, stream_min_pix=1)
    body = eng.stylize_jpeg(data, style)
    whole = nj.encode_jpeg_yuv420(*eng.stylize_planes(y, cbcr, style, on_device=True))
    assert body is not None and body == whole
    assert eng.stylize_planes_jpeg(y, cbcr, style) == whole
    host = eng.stylize_planes(y.cpu().numpy(), cbcr.cpu().numpy(), style)   # streamed
    dev = eng.stylize_planes(y, cbcr, style, on_device=True)
    for a, b in zip(host, dev):
        assert np.abs(a.astype(int) - b.cpu().numpy()).max() <= 1
    assert eng.stylize_jpeg(jfix["c444_jpeg"].tobytes(), style) is None
    assert eng.stylize_jpeg(jfix["prog_jpeg"].tobytes(), style) is None
    assert WCTEngine(mode="16x").stylize_jpeg(data, style) is None


# ---- bfloat16: the tensor-core conv3x3, the bf16 1x1, pool and upsample ----------
# Each against its plain version (float32 sums rounded once) within one bf16
# ulp elementwise: |kernel - plain| <= 2^-7 |plain|, with a floor of 1e-3
# max|plain| (both sum exact products in float32 in another order; a sum
# within that of a rounding boundary may round the other way).

BF16_CINS = [3, 16, 24, 32, 64, 128, 256]
BF16_COUTS = [3, 16, 64, 128, 512]
# (N, H, W): ragged 16x8 tiles both ways, W = 2, N = 2, one pixel
BF16_NHW = [(1, 17, 33), (1, 9, 2), (2, 5, 7), (1, 1, 1)]


def _bf16_rand(gen, *shape, offset=0, scale=1.0):
    n = 1
    for d in shape:
        n *= d
    x = ((_rand(gen, n + offset) - 0.5) * (2 * scale)).to(torch.bfloat16)
    return x[offset:].view(shape)


def _bf16_misses(got, ref) -> int:
    """Elements of ``got`` more than one bf16 ulp (2^-7 |ref|, floor 1e-3
    max|ref|) from ``ref``."""
    g, r = got.float(), ref.float()
    bound = torch.clamp(r.abs() * 2 ** -7, min=1e-3 * float(r.abs().max()))
    return int(((g - r).abs() > bound).sum())


def _conv3x3_bf16_check(gen, n, h, w, ci, co, relu=True, offset=0, bias=torch.bfloat16):
    x = _bf16_rand(gen, n, h, w, ci, offset=offset)
    wt = _bf16_rand(gen, 3, 3, ci, co, scale=(3 / (9 * ci)) ** 0.5)
    b = None if bias is None else _bf16_rand(gen, co).to(bias)
    got = kc.conv3x3_reflect(x, wt, b, relu)
    ref = kc.conv3x3_reflect_bf16.plain(x, wt, b, relu)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert _bf16_misses(got, ref) == 0


@pytest.mark.parametrize("cin", BF16_CINS)
@pytest.mark.parametrize("cout", BF16_COUTS)
@pytest.mark.parametrize("nhw", BF16_NHW, ids=str)
def test_conv3x3_bf16_matches_plain(gen, cin, cout, nhw):
    _conv3x3_bf16_check(gen, *nhw, cin, cout)


@pytest.mark.parametrize("case", [  # (N, H, W, Cin, Cout, relu, offset, bias dtype)
    (1, 33, 65, 24, 3, False, 1, torch.float32), (1, 16, 16, 5, 7, True, 3, None),
    (1, 9, 17, 512, 512, True, 0, torch.float32), (3, 8, 16, 129, 24, False, 1, None),
    (1, 40, 40, 16, 32, True, 2, torch.bfloat16), (1, 64, 48, 128, 128, True, 0, None)],
    ids=str)
def test_conv3x3_bf16_offsets_and_bias_types(gen, case):
    n, h, w, ci, co, relu, offset, bias = case
    before = (kc.conv3x3_reflect.launches, kc.conv3x3_reflect_bf16.launches)
    _conv3x3_bf16_check(gen, n, h, w, ci, co, relu, offset, bias)
    assert (kc.conv3x3_reflect.launches, kc.conv3x3_reflect_bf16.launches) == (
        before[0], before[1] + 1)


@pytest.mark.parametrize("case", [  # (P, Cin, Cout, relu, bias, offset)
    (1000, 24, 24, False, True, 0), (1000, 32, 32, False, True, 1), (777, 64, 64, False, True, 0),
    (129, 128, 128, False, True, 3), (4097, 128, 128, True, False, 0), (1, 8, 8, False, True, 0),
    (300, 3, 24, False, True, 1), (300, 24, 3, True, True, 0), (257, 96, 96, False, True, 2)],
    ids=str)
def test_conv1x1_bf16_matches_plain(gen, case):
    p, ci, co, relu, bias, offset = case
    x = _bf16_rand(gen, p, ci, offset=offset)
    wt = _bf16_rand(gen, ci, co, scale=(3 / ci) ** 0.5)
    b = _rand(gen, co) - 0.5 if bias else None
    got = kc.conv1x1_bias(x, wt, b, relu)
    ref = kc.conv1x1_bias_bf16.plain(x, wt, b, relu)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (p, co)
    assert _bf16_misses(got, ref) == 0


# The persistent ring kernel (csrc/bf16_igemm.cuh): more pixel tiles than
# blocks (every block walks its queue), Cout past a whole Cout tile (24, 3,
# 96), Cin 3, offset views, 128 -> 128 (two resident 64-wide Cout halves on
# different blocks), 512 -> 512 (streamed weights); (N, H, W, Cin, Cout, offset)
BF16_RING_CASES = [(1, 1024, 1024, 16, 16, 0), (3, 257, 255, 16, 16, 0), (3, 257, 255, 64, 64, 1),
                   (1, 200, 300, 3, 24, 0), (1, 130, 70, 16, 3, 1), (2, 67, 99, 24, 3, 0),
                   (1, 60, 90, 64, 96, 0), (1, 41, 50, 32, 24, 3), (1, 100, 120, 128, 128, 0),
                   (2, 33, 47, 128, 64, 1), (1, 20, 36, 512, 512, 0), (1, 300, 200, 3, 16, 1)]


@pytest.mark.parametrize("case", BF16_RING_CASES, ids=str)
def test_conv3x3_bf16_ring_walks_and_widths(gen, case):
    n, h, w, ci, co, offset = case
    plan = kconv.device_plan_bf16(n, h, w, ci, co, 0)
    before = kc.conv3x3_reflect_bf16.by_template[plan.kernel]
    _conv3x3_bf16_check(gen, n, h, w, ci, co, True, offset)
    assert kc.conv3x3_reflect_bf16.by_template[plan.kernel] == before + 1
    assert plan.resident == (ci <= 128)


def test_conv3x3_bf16_every_template_runs(gen):
    """One shape on each 3x3 template id, the plan's choice checked."""
    seen = set()
    for ci, co in [(3, 16), (3, 24), (16, 3), (16, 16), (16, 32), (24, 3), (32, 16), (32, 32),
                   (64, 64), (128, 128)]:
        plan = kconv.device_plan_bf16(1, 37, 45, ci, co, 0)
        seen.add(plan.template)
        _conv3x3_bf16_check(gen, 1, 37, 45, ci, co, True)
    assert seen == {t for t, v in kconv.BF16_TEMPLATES.items() if v[1] == 9}


def test_bf16_launches_back_to_back_keep_their_own_weights(gen):
    """Two shapes (and two weight sets at one shape) queued on one stream
    with no synchronisation between them: no launch sees another's
    weights, bias or tiles."""
    args = []
    for n, h, w, ci, co in [(1, 64, 96, 64, 64), (1, 64, 96, 64, 64), (1, 90, 70, 16, 32),
                            (1, 30, 40, 128, 128), (1, 90, 70, 16, 32)]:
        x = _bf16_rand(gen, n, h, w, ci)
        wt = _bf16_rand(gen, 3, 3, ci, co, scale=(3 / (9 * ci)) ** 0.5)
        args.append((x, wt, _bf16_rand(gen, co), True))
    x1 = _bf16_rand(gen, 5000, 64)
    w1 = _bf16_rand(gen, 64, 64, scale=(3 / 64) ** 0.5)
    outs = [kc.conv3x3_reflect_bf16(*a) for a in args]
    y1 = kc.conv1x1_bias_bf16(x1, w1, None, False)
    outs2 = [kc.conv3x3_reflect_bf16(*a) for a in args[::-1]][::-1]
    torch.cuda.synchronize()
    for a, got, again in zip(args, outs, outs2):
        assert _bf16_misses(got, kc.conv3x3_reflect_bf16.plain(*a)) == 0
        assert torch.equal(got, again)
    assert _bf16_misses(y1, kc.conv1x1_bias_bf16.plain(x1, w1, None, False)) == 0


@pytest.mark.parametrize("case", [  # (P, Cin, Cout, relu, bias, offset)
    (100001, 24, 24, False, True, 0), (100001, 32, 32, True, True, 1), (100001, 128, 128, False, True, 0),
    (100001, 128, 128, False, False, 0), (70001, 64, 64, False, False, 2), (9999, 16, 128, True, True, 0),
    (5000, 128, 8, False, True, 0)], ids=str)
def test_conv1x1_bf16_ring_matches_plain(gen, case):
    p, ci, co, relu, bias, offset = case
    x = _bf16_rand(gen, p, ci, offset=offset)
    wt = _bf16_rand(gen, ci, co, scale=(3 / ci) ** 0.5)
    b = _rand(gen, co) - 0.5 if bias else None
    got = kc.conv1x1_bias_bf16(x, wt, b, relu)
    ref = kc.conv1x1_bias_bf16.plain(x, wt, b, relu)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (p, co)
    assert _bf16_misses(got, ref) == 0


@pytest.mark.parametrize("shape", [(1, 8, 8, 16), (1, 7, 9, 16), (2, 5, 4, 3), (1, 1, 5, 8),
                                   (1, 64, 33, 24), (1, 6, 6, 128)], ids=str)
@pytest.mark.parametrize("offset", [0, 1])
def test_pool_and_upsample_bf16_are_exact(gen, shape, offset):
    x = _bf16_rand(gen, *shape, offset=offset)
    for k in (kc.max_pool_2x2, kc.upsample_nearest_2x):
        got = k(x)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, k.plain(x))


def test_bf16_kernels_keep_nan_and_refuse_what_they_do_not_take(gen):
    x = _bf16_rand(gen, 1, 9, 17, 16)
    x[0, 4, 8, 3] = float("nan")
    w = _bf16_rand(gen, 3, 3, 16, 16, scale=0.1)
    y = kc.conv3x3_reflect(x, w, None, True)
    ref = kc.conv3x3_reflect.plain(x, w, None, True)
    assert torch.equal(torch.isnan(y), torch.isnan(ref)) and bool(torch.isnan(y).any())
    assert bool(torch.isnan(kc.max_pool_2x2(x)).any())
    with pytest.raises(ValueError, match="top row"):   # a halo row is one row
        kc.conv3x3_reflect(x, w, None, True, top=x[:, :2])
    with pytest.raises(ValueError, match="bot row is torch.float32"):
        kc.conv3x3_reflect(x, w, None, True, bot=x[:, :1].float())
    with pytest.raises(ValueError, match="bfloat16"):
        kc.conv3x3_reflect_bf16(x, w.float(), None, True)
    with pytest.raises(ValueError, match="float32"):
        kc.conv1x1_bias(x.reshape(-1, 16), w[0, 0], w[0, 0, 0], False)   # bias must be f32


# ---- bf16 halo rows (the per-conv sharded path in bf16) ----------------------------
# (Cin, Cout) on every bf16 3x3 template: Cin 3 (registers a step ahead),
# 16 / 24 / 32, the wgmma widths 64 and 128
BF16_HALO_PAIRS = [(3, 16), (3, 24), (16, 3), (16, 16), (16, 32), (24, 3), (32, 16), (32, 32),
                   (64, 64), (64, 128), (128, 128), (128, 64)]


def _bf16_maps(gen, n, rows, w, ci, offset, pad):
    """(n, rows, w, ci) bf16 maps ``offset`` elements into a buffer that
    holds ``pad`` more elements after each image (batch stride rows * w * ci
    + pad)."""
    per = rows * w * ci
    return _bf16_rand(gen, n, per + pad, offset=offset)[:, :per].view(n, rows, w, ci)


def _halo_conv_bf16_check(gen, n, h, w, ci, co, relu, sides, offset, rows_device="cuda",
                          row_offset=None, row_pad=0):
    """The bf16 halo conv against its plain version within one bf16 ulp:
    ``x`` and two neighbour maps of other heights, each ``offset`` elements
    into its buffer (odd: off 16-byte alignment, the 2-byte staging; the
    neighbours ``row_offset`` where given, with ``row_pad`` elements after
    each image), the rows views of them (batch strides of their own maps);
    a second call bit-equal, and one halo launch a call."""
    row_offset = offset if row_offset is None else row_offset
    x = _bf16_rand(gen, n, h, w, ci, offset=offset)
    up = _bf16_maps(gen, n, 3, w, ci, row_offset, row_pad).to(rows_device)
    down = _bf16_maps(gen, n, 2, w, ci, row_offset, row_pad).to(rows_device)
    top = up[:, -1:] if sides in ("both", "top") else None
    bot = down[:, :1] if sides in ("both", "bot") else None
    wt = _bf16_rand(gen, 3, 3, ci, co, scale=(3 / (9 * ci)) ** 0.5)
    b = _bf16_rand(gen, co)
    before = (kc.conv3x3_reflect_bf16.halo_launches, kc.conv3x3_reflect.halo_launches)
    got = kc.conv3x3_reflect(x, wt, b, relu, top=top, bot=bot)
    again = kc.conv3x3_reflect_bf16(x, wt, b, relu, top=top, bot=bot)
    ref = kc.conv3x3_reflect_bf16.plain(x, wt, b, relu, top=top, bot=bot)
    torch.cuda.synchronize()
    assert (kc.conv3x3_reflect_bf16.halo_launches, kc.conv3x3_reflect.halo_launches) == (
        before[0] + 2, before[1])
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert _bf16_misses(got, ref) == 0
    assert torch.equal(got, again)


@pytest.mark.parametrize("pair", BF16_HALO_PAIRS, ids=str)
@pytest.mark.parametrize("hw", ["1x1", "2x37", "tile+1"])
@pytest.mark.parametrize("sides", ["both", "top", "bot"])
@pytest.mark.parametrize("offset", [0, 1])
def test_conv3x3_bf16_halo_rows_at_edge_shapes(gen, pair, hw, sides, offset):
    # every bf16 3x3 template; H = 1 (both rows are halo rows), W = 37 and
    # N = 2, one past the template's tile both ways (ragged tiles read no
    # row past ``bot``); a null side reflects
    ci, co = pair
    plan = kconv.device_plan_bf16(1, 64, 64, ci, co, 0)
    h, w = (plan.tile[0] + 1, plan.tile[1] + 1) if hw == "tile+1" else map(int, hw.split("x"))
    _halo_conv_bf16_check(gen, 2 if hw == "2x37" else 1, h, w, ci, co, ci % 2 == 0, sides,
                          offset)


@pytest.mark.parametrize("pair", [(16, 16), (24, 24), (32, 32), (64, 64), (64, 128),
                                  (128, 128)], ids=str)
@pytest.mark.parametrize("rows_at", [(1, 0), (4, 0), (0, 1), (0, 4)], ids=str)
@pytest.mark.parametrize("sides", ["both", "bot"])
def test_conv3x3_bf16_halo_rows_off_alignment_beside_an_aligned_map(gen, pair, rows_at, sides):
    # x 16-byte aligned with Cin % 8 == 0, the 16-byte copies' case, and only
    # the rows off 16 bytes: their start (row offset 1 or 4 elements) or, at
    # N = 2, their batch stride (1 or 4 elements of pad after each image);
    # the kernel must stage them with its 2-byte loads
    ci, co = pair
    row_offset, row_pad = rows_at
    _halo_conv_bf16_check(gen, 2, 17, 33, ci, co, True, sides, 0, row_offset=row_offset,
                          row_pad=row_pad)


@pytest.mark.parametrize("pair", BF16_HALO_PAIRS, ids=str)
@pytest.mark.parametrize("offset", [0, 1])
def test_conv3x3_bf16_own_reflection_rows_as_halos_are_bit_equal(gen, pair, offset):
    """The shard's own reflection rows given as halo rows stage the same
    values in the same order as the kernel without rows: bit-equal."""
    ci, co = pair
    x = _bf16_rand(gen, 2, 19, 37, ci, offset=offset)
    wt = _bf16_rand(gen, 3, 3, ci, co, scale=(3 / (9 * ci)) ** 0.5)
    b = _bf16_rand(gen, co)
    plain = kc.conv3x3_reflect_bf16(x, wt, b, True)
    halo = kc.conv3x3_reflect_bf16(x, wt, b, True, top=x[:, 1:2], bot=x[:, -2:-1])
    torch.cuda.synchronize()
    assert torch.equal(plain, halo)


def test_conv3x3_bf16_halo_rows_on_other_cards(gen):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    last = f"cuda:{torch.cuda.device_count() - 1}"
    for ci, co in ((16, 16), (3, 24), (64, 128), (128, 64)):
        _halo_conv_bf16_check(gen, 2, 9, 33, ci, co, True, "both", 0, rows_device=last)


@pytest.mark.parametrize("rows", [(16, 16, 16, 32), (1, 1, 1, 2), (3, 3, 3, 5)], ids=str)
def test_bf16_halo_rows_at_unequal_shard_heights(gen, rows):
    """bf16 shards of unequal heights: the slab path's halo kernel extends
    each with its pair exactly as its plain version; the bf16 halo convs
    joined stay within one ulp of the unsharded plain bf16 conv."""
    from collaborative_distillation_tpu_torch.parallel import spatial as tsp
    shards = [_bf16_rand(gen, 1, h, 37, 16) for h in rows]
    for x, (top, bot) in zip(shards, tsp.halo_rows(shards)):
        top = x[:, 1:2] if top is None else top
        bot = x[:, -2:-1] if bot is None else bot
        assert torch.equal(kc.halo_exchange_rows(x, top, bot, 1),
                           kc.halo_exchange_rows.plain(x, top, bot, 1))
    wt = _bf16_rand(gen, 3, 3, 16, 16, scale=0.2)
    b = _bf16_rand(gen, 16)
    got = torch.cat(tsp.conv3x3_halo(shards, [wt] * len(rows), [b] * len(rows)), dim=1)
    whole = kc.conv3x3_reflect_bf16.plain(torch.cat(shards, dim=1), wt, b, True)
    torch.cuda.synchronize()
    assert _bf16_misses(got, whole) == 0


def test_bf16_sharded_and_pwct_engines_on_one_card():
    """The bf16 engines that were refused before, on cuda:0: four shards
    per conv and in slabs, against the single-card bf16 engines (the slab
    path: the same sums in the same order), and photo-WCT; every conv of
    the per-conv path reads its rows in the bf16 kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    import numpy as np

    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c, s = d["content"], d["style"]
    tall = np.concatenate([c, c[::-1], c])[:1152, :128]
    bf = torch.bfloat16

    def psnr(a, b):
        mse = float(np.mean((a.astype(np.float64) - b) ** 2))
        return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)

    before = (kc.halo_exchange_rows.launches, kc.halo_fill_rows.launches)
    # conv0 run on both (packed=False): the sharded path takes the style's
    # statistics from the unfolded encoders, the single-card slab path from
    # its folded ones, and in bf16 the two roundings differ by more than the
    # order of sums (chip_smoke.py phase 5e holds the folded paths)
    sharded = WCTEngine(mode="16x", space=4, slab_rows=288, devices=["cuda:0"] * 4,
                        dtype=bf, packed=False).stylize(tall, s)
    assert (kc.halo_exchange_rows.launches - before[0],
            kc.halo_fill_rows.launches - before[1]) == (1, 4)
    assert psnr(sharded, WCTEngine(mode="16x", slab_rows=288, dtype=bf,
                                   packed=False).stylize(tall, s)) >= 40
    before = (kc.conv3x3_reflect.halo_launches, kc.conv3x3_reflect_bf16.halo_launches)
    per_conv = WCTEngine(mode="16x", space=4, devices=["cuda:0"] * 4, dtype=bf).stylize(c, s)
    assert kc.conv3x3_reflect.halo_launches == before[0]
    assert kc.conv3x3_reflect_bf16.halo_launches - before[1] == 4 * 62
    plain = WCTEngine(mode="16x", dtype=bf)
    assert psnr(per_conv, plain.stylize(c, s)) >= 30
    # photo-WCT on a 128^2 crop (at 512^2 bf16 photo-WCT stands ~12 dB from
    # float32 in both packages: bf16 ties move the unpool's maxima)
    pwct = plain.stylize(c[:128, :128], s[:64, :64], pwct=True)
    assert pwct.shape == (128, 128, 3) and np.isfinite(pwct).all()
    assert psnr(pwct, WCTEngine(mode="16x").stylize(c[:128, :128], s[:64, :64],
                                                    pwct=True)) >= 40


# bf16 training (phase 8e of chip_smoke.py): (N, H, W, Cin, Cout) of the
# stage-5 N = 16 steps' convs (the SE's first conv, the teachers' widths,
# a decoder's last) and an odd edge shape
BF16_TRAIN_CASES = [(16, 256, 256, 3, 16), (16, 128, 128, 64, 128), (16, 32, 32, 256, 512),
                    (16, 16, 16, 512, 512), (16, 256, 256, 64, 3), (2, 7, 9, 24, 32)]


@pytest.mark.parametrize("case", BF16_TRAIN_CASES, ids=str)
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_bf16_function_at_training_shapes(gen, case, relu):
    """The ``Conv3x3`` Function in bf16 (the bf16 kernel forward, cuDNN's
    bf16 backward) against autograd through the bf16 plain version (float32
    sums, one rounding), under the kernel's ReLU decisions: the forward
    within one bf16 ulp (2^-7 |ref|, floor 1e-3 max|ref|); dw and db within
    one ulp plus 1e-5 of their largest partial sum (a bf16 accumulation
    over the 1M pixels of a wgrad would miss it); dx within one ulp of
    itself and of its elementwise partial sum (the pad's gradient folds in
    bf16)."""
    from collaborative_distillation_tpu_torch.ops import conv as tconv
    from collaborative_distillation_tpu_torch.train.trainer import full_float32
    n, h, w, ci, co = case
    bf = torch.bfloat16
    x = _bf16_rand(gen, n, h, w, ci).requires_grad_()
    wt = _bf16_rand(gen, 3, 3, ci, co, scale=(3 / (9 * ci)) ** 0.5).requires_grad_()
    b = _bf16_rand(gen, co).requires_grad_()
    g = _bf16_rand(gen, n, h, w, co)
    with full_float32():
        y = tconv.conv3x3(x, wt, b, relu=relu)
        got = torch.autograd.grad(y, (x, wt, b), g)
        with torch.no_grad():
            pre = kc.conv3x3_reflect(x, wt, b, False)
            plain = kc.conv3x3_reflect_bf16.plain(x, wt, b, False)
            assert _bf16_misses(pre, plain) == 0
            assert _bf16_misses(y, plain.clamp_min(0) if relu else plain) == 0
            gp = g * (pre > 0).to(bf).masked_fill_(pre == 0, 0.5) if relu else g
        want = torch.autograd.grad(kc.conv3x3_reflect_bf16.plain(x, wt, b, False),
                                   (x, wt, b), gp)
        ab = [t.detach().float().abs().requires_grad_() for t in (x, wt, b)]
        scale = torch.autograd.grad(kc.conv3x3_reflect.plain(*ab, False), ab, gp.float().abs())
    for i, (a, r, s) in enumerate(zip(got, want, scale)):
        assert a.dtype == bf
        a, r = a.float(), r.float()
        bound = (r.abs() + s) * 2 ** -7 if i == 0 else r.abs() * 2 ** -7 + 1e-5 * s.max()
        assert bool(((a - r).abs() <= bound).all()), (i, float((a - r).abs().max()))


@pytest.mark.parametrize("shape", [(16, 256, 256, 64), (16, 32, 32, 256), (16, 16, 16, 512),
                                   (2, 7, 9, 16)], ids=str)
def test_pool_and_upsample_bf16_functions_at_training_shapes(gen, shape):
    """In bf16 on the card: the pool's gradient at each first maximum as
    ``F.max_pool2d``'s, the upsample's 2x2 sums rounded once; forwards
    equal to the plain versions."""
    from collaborative_distillation_tpu_torch.ops import conv as tconv
    bf = torch.bfloat16
    x = torch.floor(_rand(gen, *shape) * 3).to(bf).requires_grad_()
    y = tconv.max_pool_2x2(x)
    g = _bf16_rand(gen, *y.shape)
    got = torch.autograd.grad(y, x, g)[0]
    want = torch.autograd.grad(torch.nn.functional.max_pool2d(
        x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1), x, g)[0]
    assert got.dtype == bf and torch.equal(got, want)
    assert torch.equal(y, kc.max_pool_2x2.plain(x.detach()))
    n, h, w, c = shape
    u = _bf16_rand(gen, *shape).requires_grad_()
    gu = _bf16_rand(gen, n, 2 * h, 2 * w, c)
    up = tconv.upsample_nearest_2x(u)
    got = torch.autograd.grad(up, u, gu)[0]
    assert got.dtype == bf
    assert torch.equal(got, gu.float().reshape(n, h, 2, w, 2, c).sum(dim=(2, 4)).to(bf))
    assert torch.equal(up, kc.upsample_nearest_2x.plain(u.detach()))


@pytest.mark.parametrize("mode", ["wct_se", "wct_sd", "wct_sd_kd2sd"])
def test_trainer_bf16_step_on_card_matches_cpu(mode):
    """One bf16 step card vs CPU (stage 2, N = 2, 64^2): losses within 2^-6
    relative, each student leaf's gradient within 2^-4 of its norm (two
    bf16 steps that round in other orders), masters, gradients and rec
    float32, and only bf16 kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
    from collaborative_distillation_tpu_torch.models.vgg import init_params
    from collaborative_distillation_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                                    student_spec)
    gen = torch.Generator().manual_seed(0)
    frozen = {"be": init_params(encoder_spec("original", 2), gen),
              "bd": init_params(decoder_spec("original", 2), gen),
              "se": init_params(encoder_spec("16x", 2, aux=True), gen)}
    cfg = TrainConfig(mode=mode, stage=2, compute_dtype="bfloat16")
    student = init_params(student_spec(cfg), gen)
    batch = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    card, cpu = (Trainer(cfg, student, frozen, device=d) for d in ("cuda", "cpu"))
    for k in kc.KERNELS + kc.BF16_KERNELS:
        k.launches = 0
    lc, rec = card.train_step(batch)
    torch.cuda.synchronize()
    assert all(k.launches == 0 for k in kc.KERNELS)
    assert kc.conv3x3_reflect_bf16.launches > 0 and kc.max_pool_2x2_bf16.launches > 0
    lp, _ = cpu.train_step(batch)
    assert rec.dtype == torch.float32
    for name in lp:
        assert abs(float(lc[name]) - float(lp[name])) <= 2 ** -6 * abs(float(lp[name]))
    for name, leaf in cpu.params.items():
        for kind, t in leaf.items():
            gc = card.params[name][kind].grad
            assert gc.dtype == card.params[name][kind].dtype == torch.float32
            err = float((gc.cpu().double() - t.grad.double()).norm())
            assert err <= 2 ** -4 * float(t.grad.double().norm()), (name, kind)


# ---- the training loader's JPEG decode on the card --------------------------------------
# (nvJPEG's whole decode, then ops/cuda/resize.py's kernels; the reference's
# outputs in collaborative_distillation_tpu_torch/data/jpeg_train_fixture.npz,
# made on a host with libjpeg by tools/make_jpeg_train_fixture.py)

TRAIN_JPEG_FILES = ["d1", "d2", "d4", "d8", "c444", "prog", "up", "coco"]


@pytest.fixture(scope="module")
def tfix():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    import numpy as np
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "collaborative_distillation_tpu_torch", "data",
                              "jpeg_train_fixture.npz")) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (5, 1), (9, 13), (17, 31), (64, 6),
                                   (333, 451), (1300, 1703)], ids=str)
@pytest.mark.parametrize("denom", [1, 2, 4, 8])
def test_scale_reduce_kernel_is_bit_equal_to_plain(gen, shape, denom):
    """1-pixel outputs, widths not a multiple of 4 or of ``denom``."""
    x = (_rand(gen, *shape, 3) * 256).to(torch.uint8)
    before = kc.scale_reduce_u8.launches
    got = kc.scale_reduce_u8(x, denom)
    torch.cuda.synchronize()
    assert torch.equal(got, kc.scale_reduce_u8.plain(x, denom))
    assert kc.scale_reduce_u8.launches == before + 1


@pytest.mark.parametrize("size", [  # (sh, sw, dh, dw)
    (1, 1, 1, 1), (1, 1, 5, 3), (7, 9, 1, 1), (10, 13, 3, 5), (5, 5, 9, 11), (17, 31, 16, 1),
    (350, 500, 300, 429), (413, 313, 396, 300), (257, 383, 300, 447), (480, 640, 300, 400),
    (325, 427, 300, 394)], ids=str)
def test_box_resize_kernel_is_bit_equal_to_plain(gen, size):
    """Downscales, upscales, 1-pixel outputs, widths not a multiple of 4."""
    sh, sw, dh, dw = size
    x = (_rand(gen, sh, sw, 3) * 256).to(torch.uint8)
    got = kc.box_resize_u8(x, dw, dh)
    torch.cuda.synchronize()
    assert torch.equal(got, kc.box_resize_u8.plain(x, dw, dh))


def test_jpeg_resize_kernels_refuse_what_they_do_not_take(gen):
    x = (_rand(gen, 8, 8, 3) * 256).to(torch.uint8)
    with pytest.raises(ValueError, match="contiguous"):
        kc.box_resize_u8(x.transpose(0, 1), 3, 3)
    with pytest.raises(ValueError, match="uint8"):
        kc.scale_reduce_u8(x.float(), 2)


@pytest.mark.parametrize("name", TRAIN_JPEG_FILES)
def test_card_shorter_side_decode_against_the_reference(tfix, name):
    """nvJPEG's whole decode and the kernels: each kernel bit-equal to its
    plain version on the decode, the chain within 40 dB of the reference's
    libjpeg scaled decode (nvJPEG's decode is not libjpeg's, and the block
    mean is not the scaled IDCT)."""
    from collaborative_distillation_tpu_torch.data import jpeg, nvjpeg_codec as nj
    data, side = tfix[f"{name}_jpeg"].tobytes(), int(tfix[f"{name}_side"])
    whole = nj.decode_jpeg(data)
    denom, scaled, (dh, dw) = jpeg.shorter_side_plan(whole.shape[0], whole.shape[1], side)
    reduced = kc.scale_reduce_u8(whole, denom)
    assert torch.equal(reduced, kc.scale_reduce_u8.plain(whole, denom))
    assert torch.equal(kc.box_resize_u8(reduced, dw, dh),
                       kc.box_resize_u8.plain(reduced, dw, dh))
    got = jpeg.decode_jpeg_shorter_side(data, side, "cuda")
    assert got.device.type == "cuda" and tuple(got.shape) == tfix[f"{name}_out"].shape
    assert _psnr_u8(got.cpu().numpy(), tfix[f"{name}_out"]) >= 40.0


def test_card_dataset_decodes_on_side_streams_in_a_two_thread_loader(tfix, tmp_path):
    """``ImageFolderDataset(device="cuda")`` in a 2-thread ``Loader``: each
    item's decode equals the main thread's, the kernels launch, and a decode
    does not queue behind work on the card's default stream (a step's)."""
    import threading

    import numpy as np

    from collaborative_distillation_tpu_torch.data import pipeline as tpipe
    for name in TRAIN_JPEG_FILES:
        (tmp_path / f"{name}.jpg").write_bytes(tfix[f"{name}_jpeg"].tobytes())
    ds = tpipe.ImageFolderDataset(str(tmp_path), 40, 32, uint8=True, device="cuda")
    assert ds.device == torch.device("cuda", torch.cuda.current_device())
    want = {p: ds._decode(p) for p in ds.paths}
    before = (kc.scale_reduce_u8.launches, kc.box_resize_u8.launches)
    batches = list(tpipe.Loader(ds, 4, num_workers=2, seed=3))
    assert len(batches) == 2 and all(b.shape == (4, 32, 32, 3) and b.dtype == np.uint8
                                     for b, _ in batches)
    assert kc.scale_reduce_u8.launches > before[0] and kc.box_resize_u8.launches > before[1]
    got = {}
    threads = [threading.Thread(target=lambda ps: got.update({p: ds._decode(p) for p in ps}),
                                args=(ds.paths[i::2],)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for p in ds.paths:
        np.testing.assert_array_equal(got[p], want[p])
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)   # ~1 s of the default stream
    out = []
    t = threading.Thread(target=lambda: out.append(ds._decode(ds.paths[0])))
    t.start()
    t.join(timeout=120)
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out[0], want[ds.paths[0]])
    assert busy, "the decode waited for the default stream"


# ---- the conv with its pool or upsample folded in (ops/cuda/fused.py) -------------------

# (kind, N, H, W, Cin, Cout, relu), (H, W) the conv's map: the fused widths at
# one past each template's pixel tile (float32 32x32, 16x32, 16x16, 8x16;
# bf16 32x32, 16x32, 16x16), odd H or W (the pool's dropped row and column,
# the upsample's odd half-resolution input), 1-pixel pooled outputs and
# upsampled inputs, N = 2, and a deeper map of each width
FUSED_CASES = [("pool", 1, 33, 33, 16, 16, True), ("pool", 2, 17, 33, 32, 32, True),
               ("pool", 1, 17, 17, 64, 64, False), ("pool", 1, 9, 17, 128, 128, True),
               ("pool", 1, 7, 9, 16, 16, True), ("pool", 2, 13, 5, 128, 128, True),
               ("pool", 1, 3, 2, 64, 64, True), ("pool", 1, 130, 66, 32, 32, True),
               ("up", 1, 34, 34, 16, 16, True), ("up", 2, 18, 34, 32, 32, True),
               ("up", 1, 18, 18, 64, 64, False), ("up", 1, 10, 18, 128, 128, True),
               ("up", 1, 2, 2, 16, 16, True), ("up", 1, 2, 2, 128, 128, True),
               ("up", 2, 14, 6, 64, 64, True), ("up", 1, 130, 66, 16, 16, True)]


def _fused_pair(kind, x, wt, b, relu):
    if kind == "pool":
        return kc.conv3x3_pool(x, wt, b, relu), kc.max_pool_2x2(kc.conv3x3_reflect(x, wt, b, relu))
    return kc.conv3x3_up(x, wt, b, relu), kc.conv3x3_reflect(kc.upsample_nearest_2x(x), wt, b, relu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FUSED_CASES, ids=str)
@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
def test_fused_conv_is_the_two_kernel_sequence_bit_for_bit(gen, dtype, case, nan):
    """conv3x3_pool / conv3x3_up against the conv kernel and the pool or
    upsample kernel in sequence: the same bits, NaN (which wins a max) and
    signed zeros included; and the plain version within the conv's
    tolerance (bf16: one ulp) where it is finite, NaN where it is NaN."""
    kind, n, h, w, ci, co, relu = case
    xh, xw = (h, w) if kind == "pool" else (h // 2, w // 2)
    x = _rand(gen, n, xh, xw, ci).to(dtype)
    if nan:
        x.view(-1)[::4099] = float("nan")
    wt = ((_rand(gen, 3, 3, ci, co) - 0.5) * (2 / (9 * ci) ** 0.5)).to(dtype)
    b = (_rand(gen, co) - 0.5).to(dtype)
    got, pair = _fused_pair(kind, x, wt, b, relu)
    ref = (kc.conv3x3_pool if kind == "pool" else kc.conv3x3_up).plain(x, wt, b, relu)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert got.shape == pair.shape == ref.shape and got.dtype == dtype
    assert torch.equal(got.view(bits), pair.view(bits))
    g, r = got.float(), ref.float()
    assert torch.equal(torch.isnan(g), torch.isnan(r))
    fin = ~torch.isnan(r)
    if not bool(fin.any()):   # a map small enough that its one NaN reaches every output
        return
    if dtype == torch.bfloat16:
        bound = torch.clamp(r.abs() * 2.0 ** -7, min=1e-3 * float(r[fin].abs().max()))
    else:
        scale = float(x.nan_to_num(0.0).abs().max() * wt.abs().sum(dim=(0, 1, 2)).max()
                      + b.abs().max())
        bound = torch.full_like(r, 1e-5 * scale)
    assert bool(((g - r).abs() <= bound)[fin].all())


def test_fused_kernels_refuse_unfused_templates_and_count(gen):
    x = _rand(gen, 1, 8, 8, 256)
    with pytest.raises(ValueError, match="no fused"):
        kc.conv3x3_pool(x, _rand(gen, 3, 3, 256, 256), None, True)
    with pytest.raises(ValueError, match="no fused"):
        kc.conv3x3_up(x[..., :3].contiguous(), _rand(gen, 3, 3, 3, 24), None, True)
    before = (kc.conv3x3_pool.launches, kc.conv3x3_up_bf16.launches)
    kc.conv3x3_pool(x[..., :16].contiguous(), _rand(gen, 3, 3, 16, 16), None, True)
    kc.conv3x3_up(x[..., :32].contiguous().bfloat16(), _rand(gen, 3, 3, 32, 32).bfloat16(),
                  None, True)
    assert (kc.conv3x3_pool.launches, kc.conv3x3_up_bf16.launches) == (before[0] + 1,
                                                                      before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_route_cascade_is_the_separate_route_bit_for_bit(dtype):
    """WCTEngine on a 512^2 pair, the fused route against the separate
    kernels (``ops.conv.FUSE_DEVICES`` empty): equal outputs, no pool or
    upsample launch on the fused route, the same number of convs."""
    import os

    import numpy as np

    from collaborative_distillation_tpu_torch.ops import conv as tconv
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with np.load(os.path.join(os.path.dirname(__file__), "..", "collaborative_distillation_tpu_torch",
                              "data", "photo_pair_512.npz")) as d:
        c, s = d["content"], d["style"]
    eng = WCTEngine(mode="16x", dtype=dtype)
    img, sty = eng._prep(c), eng._prep(s)
    every = kc.KERNELS + kc.BF16_KERNELS
    outs, counts = [], []
    on = tconv.FUSE_DEVICES
    try:
        for devices in (on, frozenset()):
            tconv.FUSE_DEVICES = devices
            for k in every:
                k.launches = 0
            with torch.inference_mode():
                outs.append(eng.stylize_device(img, sty))
            torch.cuda.synchronize()
            counts.append({k.__name__: k.launches for k in every})
    finally:
        tconv.FUSE_DEVICES = on
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(outs[0].view(bits), outs[1].view(bits))
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    fused, sep = counts
    assert fused["max_pool_2x2" + sfx] == fused["upsample_nearest_2x" + sfx] == 0
    assert (fused["conv3x3_pool" + sfx], fused["conv3x3_up" + sfx]) == (20, 10)
    assert (sep["max_pool_2x2" + sfx], sep["upsample_nearest_2x" + sfx]) == (20, 10)
    convs = lambda cnt: sum(cnt[k + sfx] for k in ("conv3x3_reflect", "conv3x3_pool",
                                                   "conv3x3_up"))
    assert convs(fused) == convs(sep) == 93


@pytest.mark.parametrize("nbytes,buffers", [(1000, 1), (3 << 19, 2), (3 << 20, 2)], ids=str)
def test_push_and_fetch_count_their_pinned_buffers(gen, nbytes, buffers):
    """push counts its staging buffers (one, or two for an array of more
    than one chunk) and their bytes, fetch its pinned output; counters()
    reads them."""
    import numpy as np

    from collaborative_distillation_tpu_torch.utils.profiling import counters
    from collaborative_distillation_tpu_torch.utils.transfer import fetch, push
    chunk = 1 << 20
    a = np.arange(nbytes, dtype=np.int64).astype(np.uint8)
    before = counters()
    x = push(a, "cuda", chunk_bytes=chunk)
    pushed = counters()
    assert pushed["pinned_buffers"] - before["pinned_buffers"] == buffers
    assert pushed["pinned_bytes"] - before["pinned_bytes"] == buffers * min(chunk, nbytes)
    np.testing.assert_array_equal(fetch(x), a)
    after = counters()
    assert after["pinned_buffers"] - pushed["pinned_buffers"] == 1
    assert after["pinned_bytes"] - pushed["pinned_bytes"] == nbytes


def test_streamed_tail_counts_its_band_buffers(monkeypatch):
    """A uint8 call on the fused slab path streams its last stage through
    two pinned band buffers, counted with the uploads' staging, and fetches
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from collaborative_distillation_tpu_torch.utils import transfer
    from collaborative_distillation_tpu_torch.utils.profiling import counters
    from collaborative_distillation_tpu_torch.wct import engine as weng
    from collaborative_distillation_tpu_torch.wct import slab as wslab
    eng = weng.WCTEngine(mode="16x", slab_rows=288, stream_min_pix=1)
    g = np.random.default_rng(0)
    c = g.integers(0, 256, (640, 64, 3), dtype=np.uint8)
    s = g.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    made = {"bands": [], "transfer": []}

    def counted(where, alloc):
        return lambda shape, dtype: made[where].append(alloc(shape, dtype)) or made[where][-1]
    monkeypatch.setattr(wslab, "pinned_empty", counted("bands", transfer.pinned_empty))
    monkeypatch.setattr(transfer, "pinned_empty", counted("transfer", transfer.pinned_empty))
    monkeypatch.setattr(weng, "fetch", lambda x: pytest.fail("the streamed tail fetched"))
    before = counters()
    out = eng.stylize(c, s, as_uint8=True)
    assert out.shape == c.shape and out.dtype == np.uint8
    after = counters()
    rows = max(n for *_, n in eng.slab._slabs(640, eng.stages[-1]))
    assert [b.nbytes for b in made["bands"]] == [rows * 64 * 3] * 2
    every = made["bands"] + made["transfer"]
    assert after["pinned_buffers"] - before["pinned_buffers"] == len(every)
    assert after["pinned_bytes"] - before["pinned_bytes"] == sum(b.nbytes for b in every)


def _photo_pair():
    import os

    import numpy as np
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        return d["content"], d["style"]


def _tiled(img, h, w):
    """A host uint8 image reflect-tiled to (h, w) on the card, in [0, 1]."""
    from collaborative_distillation_tpu_torch.ops.pad import reflect_index
    x = torch.from_numpy(img).cuda()
    x = x.index_select(0, reflect_index(x.shape[0], 0, h - x.shape[0], x.device))
    return x.index_select(1, reflect_index(x.shape[1], 0, w - x.shape[1], x.device)).float() / 255


# sym_eigh in float32 against float64: eigenvalues and the reconstruction
# relative to the largest eigenvalue, V's orthogonality. The kernel reads at
# most 3.6e-5 (orthogonality at n = 128), cuSOLVER's float32 eigh 3.8e-5 on
# the same matrices: rounding of some hundreds of rotations a column
EIGH_TOL = 1e-4


def _check_eigh(a, w, v, sweeps):
    from collaborative_distillation_tpu_torch.ops.cuda import eigh as ke
    a64, w32, v32 = a.double(), w.double(), v.double()
    w64 = torch.linalg.eigh(a64)[0]
    scale = w64.abs().amax(1)
    n = a.shape[-1]
    assert float(((w32 - w64).abs().amax(1) / scale).max()) <= EIGH_TOL
    rec = ((v32 * w32[:, None, :]) @ v32.mT - a64).abs().amax((1, 2)) / scale
    assert float(rec.max()) <= EIGH_TOL
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    assert float((v32.mT @ v32 - eye).abs().max()) <= EIGH_TOL
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    assert int(sweeps.max()) < ke.MAX_SWEEPS


@pytest.mark.parametrize("n", [1, 2, 3, 24, 32, 64, 127, 128])
def test_sym_eigh_matches_float64(gen, n):
    """X^T X of a tall X and of one of rank n // 3, in one launch."""
    from collaborative_distillation_tpu_torch.ops.cuda import eigh as ke
    x = torch.randn(2, 4 * n + 5, n, generator=gen, device="cuda")
    x[1, max(n // 3, 1):] = 0
    a = (x.mT @ x).contiguous()
    launched = ke.sym_eigh.launches
    w, v, sweeps = ke.sym_eigh(a)
    torch.cuda.synchronize()
    assert ke.sym_eigh.launches == launched + 1 and sweeps.dtype == torch.int32
    _check_eigh(a, w, v, sweeps)
    # the kernel reads the lower triangle, as torch.linalg.eigh does
    w2, v2, _ = ke.sym_eigh((torch.tril(a) + 7.0 * torch.triu(torch.ones_like(a), 1))
                            .contiguous())
    assert torch.equal(w, w2) and torch.equal(v, v2)


@pytest.mark.parametrize("path", ["uhd_slab", "plain_2k"])
def test_sym_eigh_on_the_cascades_covariances(path):
    """The stacks the cd16x UHD slab and 2048^2 plain cascades hand the
    kernel, one a stage: each within EIGH_TOL of float64, sweeps under the
    cap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from collaborative_distillation_tpu_torch.ops import wct_transform as tw
    from collaborative_distillation_tpu_torch.ops.cuda import eigh as ke
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    c, s = _photo_pair()
    eng, hw = ((WCTEngine(mode="16x", slab_rows=1024), (4096, 10240)) if path == "uhd_slab"
               else (WCTEngine(mode="16x"), (2048, 2048)))
    img, sty = eng._prep(_tiled(c, *hw)), eng._prep(_tiled(s, 2048, 2048))
    stacks = []
    try:   # the wrapper counts its launches on its own name: leave its module as it is
        tw._keigh = types.SimpleNamespace(
            MAX_N=ke.MAX_N, sym_eigh=lambda a: stacks.append(a.clone()) or ke.sym_eigh(a))
        with torch.inference_mode():
            eng.stylize_device(img, sty)
    finally:
        tw._keigh = ke
    widths = [eng.pyramid[k]["enc_spec"].out_channels for k in eng.stages]
    assert [tuple(a.shape) for a in stacks] == [(2, c, c) for c in widths]
    for a in stacks:
        _check_eigh(a, *ke.sym_eigh(a))


@pytest.mark.parametrize("path", ["uhd_slab", "plain_2k"])
def test_cascade_runs_without_a_host_sync(path):
    """A whole cd16x cascade, UHD slab or 2048^2 plain, under sync debug mode
    "error", which raises at any call that waits for the card; for each
    image, every stage's content and style covariances on the kernel, one
    launch a stage, none on the library."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from collaborative_distillation_tpu_torch.utils.profiling import counters
    from collaborative_distillation_tpu_torch.wct.engine import WCTEngine
    c, s = _photo_pair()
    eng, hw = ((WCTEngine(mode="16x", slab_rows=1024), (4096, 10240)) if path == "uhd_slab"
               else (WCTEngine(mode="16x"), (2048, 2048)))
    img, sty = eng._prep(_tiled(c, *hw)), eng._prep(_tiled(s, 2048, 2048))
    with torch.inference_mode():
        want = eng.stylize_device(img, sty)   # warm: builds, plans, allocator
        torch.cuda.synchronize()
        before, launched = counters(), kc.sym_eigh.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = eng.stylize_device(img, sty)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    after = counters()
    stages = len(eng.stages)
    assert (after["eigh_kernel"] - before["eigh_kernel"],
            after["eigh_library"] - before["eigh_library"],
            kc.sym_eigh.launches - launched) == (2 * stages, 0, stages)
    assert torch.equal(got, want)
