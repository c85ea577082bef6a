"""The PyTorch port's kernel functions (plain versions, on the CPU) against the
reference package's Pallas kernels in interpret mode and its XLA ops.

Inputs come from numpy with a seed and go unchanged to both sides. Per-op
tolerances are near float32 epsilon: rtol = atol = 2e-5 (as
tests/test_pallas_conv.py holds the Pallas convs against XLA), since the two
sides only sum the same products in another order; pool and upsample are
exact.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from collaborative_distillation_tpu.ops import conv as jconv
from collaborative_distillation_tpu.ops.pallas.conv import (
    conv3x3_subin, conv3x3_tiled, make_pad_columns)
from collaborative_distillation_tpu.ops.pallas.pool import (
    packed_pool_lane, packed_upsample_lane)
from collaborative_distillation_tpu.ops.pallas.stats import fused_sum_gram

import torch

import chip_smoke
from collaborative_distillation_tpu_torch.models.zoo import stage_specs
from collaborative_distillation_tpu_torch.ops import conv as tconv
from collaborative_distillation_tpu_torch.ops.cuda import conv as kconv
from collaborative_distillation_tpu_torch.ops.cuda import pool as kpool
from collaborative_distillation_tpu_torch.ops.cuda import stats as kstats
from collaborative_distillation_tpu_torch.ops.pad import reflect_index
from collaborative_distillation_tpu_torch.wct.slab import FEATURE_CACHE_BYTES, SlabCascade

TOL = dict(rtol=2e-5, atol=2e-5)

# (Cin, Cout) of every 3x3 conv of the mode-16x pyramid, encoders then the
# decoder mirrors
PAIRS_16X = [(3, 24), (3, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64),
             (64, 128), (128, 128), (128, 64), (64, 32), (32, 16), (16, 3), (24, 3)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv_inputs(rng, h, w, cin, cout, n=1):
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, wt, b


def _port_conv(x, wt, b, relu):
    return tconv.conv3x3(torch.from_numpy(x), torch.from_numpy(wt),
                         torch.from_numpy(b), relu=relu).numpy()


@pytest.mark.parametrize("pair", PAIRS_16X, ids=str)
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_matches_pallas_tiled_and_xla(rng, pair, relu):
    cin, cout = pair
    x, wt, b = _conv_inputs(rng, 16, 16, cin, cout)
    got = _port_conv(x, wt, b, relu)
    xla = jconv.conv3x3(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), relu=relu)
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)
    xk = jnp.asarray(x[0])
    pallas = conv3x3_tiled(xk, make_pad_columns(xk, 1), jnp.asarray(wt.reshape(9, cin, cout)),
                           jnp.asarray(b), relu=relu, block_h=8, block_w=8,
                           ci_tile=cin, co_tile=cout, interpret=True)
    np.testing.assert_allclose(got[0], np.asarray(pallas), **TOL)


@pytest.mark.parametrize("cin", [3, 16, 24, 32, 64])
def test_conv3x3_matches_pallas_subin(rng, cin):
    """The sub-dense-input Pallas route's Cin classes, same function."""
    cout = {3: 24, 16: 32, 24: 3, 32: 64, 64: 128}[cin]
    x, wt, b = _conv_inputs(rng, 16, 16, cin, cout)
    xk = jnp.asarray(x[0])
    pallas = conv3x3_subin(xk, make_pad_columns(xk, 1), jnp.asarray(wt.reshape(9, cin, cout)),
                           jnp.asarray(b), relu=True, block_h=8, block_w=8, interpret=True)
    np.testing.assert_allclose(_port_conv(x, wt, b, True)[0], np.asarray(pallas), **TOL)


@pytest.mark.parametrize("hw", [(1, 1), (1, 7), (5, 1), (2, 3), (17, 9)], ids=str)
def test_conv3x3_one_pixel_and_odd_maps_match_xla(rng, hw):
    """A size-1 axis reflects onto itself, as jnp.pad(mode="reflect") does
    (F.pad(mode="reflect") refuses it); the Pallas kernels need H, W >= 8."""
    x, wt, b = _conv_inputs(rng, *hw, 16, 32, n=2)
    xla = jconv.conv3x3(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), relu=True)
    np.testing.assert_allclose(_port_conv(x, wt, b, True), np.asarray(xla), **TOL)


@pytest.mark.parametrize("n", [1, 2, 3, 10])
@pytest.mark.parametrize("pads", [(1, 1), (0, 6), (0, 15), (3, 0)], ids=str)
def test_reflect_index_matches_numpy(n, pads):
    idx = reflect_index(n, *pads, "cpu").numpy()
    want = np.pad(np.arange(n), pads, mode="reflect")
    np.testing.assert_array_equal(idx, want)


@pytest.mark.parametrize("c", [24, 32, 64, 128])
@pytest.mark.parametrize("shifted", [False, True])
def test_sum_gram_matches_pallas_fused_sum_gram(rng, c, shifted):
    p = 1000  # ragged: not a multiple of the 256-row block
    x = (rng.standard_normal((p, c)) * 2 + 3).astype(np.float32)
    shift = x[:64].mean(0) if shifted else None
    s, g = kstats.sum_gram_plain(torch.from_numpy(x),
                                 None if shift is None else torch.from_numpy(shift))
    js, jg = fused_sum_gram(jnp.asarray(x if shift is None else x - shift),
                            block_rows=256, interpret=True)
    # sums of 1000 terms: scale the tolerance to the sum's magnitude
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=2e-5, atol=2e-5 * scale)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2e-5,
                               atol=2e-5 * np.abs(x).sum(0).max())


@pytest.mark.parametrize("c", [24, 32, 64, 128, 3, 129, 512])
@pytest.mark.parametrize("p", [1, 33, 161, 16384, 1056001, 41943040])
@pytest.mark.parametrize("n_sm", [132, 1])
def test_sum_gram_launch_plan_covers_every_row_once(p, c, n_sm):
    nblocks, rows = kstats.launch_plan(p, c, n_sm)
    ranges = [(k * rows, min(p, (k + 1) * rows)) for k in range(nblocks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == p
    assert all(a < b for a, b in ranges)               # no block without rows
    assert all(b == a2 for (_, b), (a2, _) in zip(ranges, ranges[1:]))
    if c in kstats._ROW_KERNEL:                        # one wave of row blocks
        step, per_sm = kstats._ROW_KERNEL[c]
        assert rows % step == 0 and nblocks <= per_sm * n_sm


def _path_conv_shapes():
    """(N, H, W, Cin, Cout) of every conv3x3 launch on the 2048^2 plain, UHD
    slab (slab_rows=1024), sharded UHD (space=4, slab_rows=512) and plain
    UHD paths of mode 16x, from chip_smoke.py's plans and the specs alone
    (a fused conv + pool or upsample + conv at its conv's shape)."""
    stages = (5, 4, 3, 2, 1)
    pyr = {k: dict(zip(("enc_spec", "dec_spec"), stage_specs("16x", k))) for k in stages}
    margins = SlabCascade(pyr, stages=stages, slab_rows=1024).margins
    h, w = chip_smoke.UHD_H, chip_smoke.UHD_W
    plans = [chip_smoke.path_calls(pyr, stages, 2048, 2048),
             chip_smoke.path_calls(pyr, stages, h, w),
             chip_smoke.slab_path_calls(pyr, stages, margins, 1024, h, w, 2048, 2048,
                                        FEATURE_CACHE_BYTES),
             chip_smoke.sharded_path_calls(pyr, stages, margins, 512, 4, h, w, 2048, 2048)]
    return sorted({s[:5] for calls, _ in plans for k, s in calls if k in chip_smoke.CONV_KERNELS})


# the reference's VGG-19 teachers (mode "original"): widths up to 512
TEACHER_SHAPES = [(1, 512, 512, ci, co) for ci, co in
                  [(3, 64), (64, 64), (64, 128), (128, 256), (256, 256), (256, 512),
                   (512, 512), (512, 256), (256, 128), (128, 64), (64, 3)]]
EDGE_SHAPES = [(1, 1, 1, 128, 128), (2, 3, 5, 24, 3), (1, 17, 33, 3, 16), (1, 2, 1, 16, 16),
               (3, 9, 65, 16, 3), (1, 33, 17, 32, 24), (1, 4, 4, 5, 7), (65535, 1, 1, 8, 8),
               (70000, 1, 1, 16, 16), (1, 1, 1, 512, 512), (2, 9, 17, 256, 512),
               (1, 17, 33, 512, 3), (1, 5, 5, 129, 256), (1, 5, 5, 256, 129)]


def _wct_se_conv_shapes():
    """{(N, H, W, Cin, Cout): calls} of the conv3x3 launches of a wct_se
    training step at stage 5 x 16 x 256^2 (chip_smoke.py phases 8c, 8d)."""
    from collections import Counter
    calls = Counter()
    for s, n in chip_smoke.train_conv_calls("wct_se").items():
        calls[s[:5]] += n
    return calls


@pytest.mark.parametrize("shape", _path_conv_shapes() + TEACHER_SHAPES + EDGE_SHAPES
                         + sorted(_wct_se_conv_shapes()), ids=str)
@pytest.mark.parametrize("n_sm", [132, 1])
def test_conv3x3_launch_plan_covers_the_output_once(shape, n_sm):
    n, h, w, cin, cout = shape
    plan = kconv.launch_plan(n, h, w, cin, cout, n_sm)
    ring = cin in kconv.RING_WIDTHS and cout in kconv.RING_WIDTHS
    assert (plan.kernel != "first") == ring and (plan.template > 0) == ring
    th, tw = plan.tile
    tiles_h, tiles_w = -(-h // th), -(-w // tw)
    if not ring:   # a block per (tile, Cout tile, image)
        assert plan.tiles == n * tiles_h * tiles_w < 2 ** 31
        assert plan.grid == (tiles_h * tiles_w, -(-cout // plan.cout_tile), n)
        assert plan.grid[1] <= 65535 and plan.grid[2] <= kconv.MAX_GRID_Z
        return
    # a Cout wider than the template's tile only on the Cout-walking ones
    nco = -(-cout // plan.cout_tile)
    assert nco == 1 or plan.kernel.startswith("ring_walk")
    assert plan.tiles == n * tiles_h * tiles_w * nco < 2 ** 31
    # one persistent wave; block b takes work items b, b + grid, ...: every
    # block has an item and every item one block
    assert plan.grid[1:] == (1, 1) and 1 <= plan.grid[0] <= min(plan.tiles, n_sm)
    items = np.concatenate([np.arange(b, plan.tiles, plan.grid[0]) for b in range(plan.grid[0])])
    assert np.array_equal(np.sort(items), np.arange(plan.tiles))
    # item i's pixel tile and Cout tile, the tile's image and first row and
    # column, as the kernel computes them (Cout tile innermost)
    tile, cot = np.divmod(items, nco)
    img, r = np.divmod(tile, tiles_h * tiles_w)
    y0, x0, co0 = (r // tiles_w) * th, (r % tiles_w) * tw, cot * plan.cout_tile
    assert len(set(zip(img.tolist(), y0.tolist(), x0.tolist(), co0.tolist()))) == plan.tiles
    assert img.min() == 0 and img.max() == n - 1
    assert (y0 % th == 0).all() and (x0 % tw == 0).all() and (y0 < h).all() and (x0 < w).all()
    assert (co0 < cout).all()
    # every output pixel and cout once: the clipped boxes' volumes add up
    area = (np.minimum(y0 + th, h) - y0) * (np.minimum(x0 + tw, w) - x0)
    couts = np.minimum(co0 + plan.cout_tile, cout) - co0
    assert int((area * couts).sum()) == n * h * w * cout


def test_conv3x3_launch_plan_takes_the_ring_at_every_path_width():
    shapes = _path_conv_shapes()
    kinds = {kconv.launch_plan(*s, 132).kernel for s in shapes}
    assert "first" not in kinds and len(shapes) > 40
    # the teachers' widths take the ring too, the 27 teacher-width convs of a
    # wct_se step the Cout-walking template; an odd width still plans the
    # first kernel
    step = _wct_se_conv_shapes()
    assert sum(n for s, n in step.items() if chip_smoke.teacher_width(s)) == 27
    assert sum(n for s, n in chip_smoke.original_conv_calls(1024).items()
               if chip_smoke.teacher_width(s)) == 45
    assert "first" not in {kconv.launch_plan(*s, 132).kernel for s in TEACHER_SHAPES + list(step)}
    assert {kconv.launch_plan(*s, 132).kernel for s in step
            if chip_smoke.teacher_width(s)} == {"ring_walk64"}
    for ci, co in ((129, 64), (256, 129), (3, 129), (600 // 5, 512)):
        assert kconv.launch_plan(1, 64, 64, ci, co, 132).kernel == "first"
    with pytest.raises(ValueError, match="batch"):   # past gridDim.z: refused, not launched
        kconv.launch_plan(70000, 1, 1, 8, 8, 132)


def test_conv3x3_plan_templates_match_the_cuda_source():
    """The plan's table (Cout tile, tile rows and columns) is the one
    csrc/conv3x3.cu instantiates, template by template, by id."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(kconv.__file__), "csrc", "conv3x3.cu")).read()
    params = {name: [int(v) for v in args.split(",")[:4]] for name, args in
              re.findall(r"using (Ring\w+) = Ring<([^>]*)>;", src)}
    cases = dict((int(i), name) for i, name in
                 re.findall(r"case (\d+):\s*return launch_ring<(\w+)>", src))
    assert sorted(cases) == sorted(kconv._TEMPLATES)
    for tid, (_, co_t, th, tw) in kconv._TEMPLATES.items():
        c_co_t, _, c_th, c_tw = params[cases[tid]]
        assert (co_t, th, tw) == (c_co_t, c_th, c_tw), tid


@pytest.mark.parametrize("hw", [(7, 9), (8, 16), (5, 4)], ids=str)
@pytest.mark.parametrize("c", [16, 3])
def test_max_pool_matches_pallas_and_xla(rng, hw, c):
    h, w = hw
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    got = kpool.max_pool_2x2_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jconv.max_pool_2x2(jnp.asarray(x))))
    # the Pallas f == 1 route pools an even width (its caller crops W)
    we = w // 2 * 2
    pallas = packed_pool_lane(jnp.asarray(x[0, :, :we]), f=1, c=c, block_h=h // 2,
                              block_w=we, interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(pallas))
    assert tconv.max_pool_2x2(torch.from_numpy(x)).shape == (1, h // 2, w // 2, c)


@pytest.mark.parametrize("hw", [(3, 5), (4, 8)], ids=str)
@pytest.mark.parametrize("c", [16, 3])
def test_upsample_matches_pallas_and_xla(rng, hw, c):
    h, w = hw
    x = rng.standard_normal((1, h, w, c)).astype(np.float32)
    got = tconv.upsample_nearest_2x(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jconv.upsample_nearest_2x(jnp.asarray(x))))
    pallas = packed_upsample_lane(jnp.asarray(x[0]), f=1, c=c, block_h=h, block_w=w,
                                  interpret=True)
    # f == 1: (2H, W, 2C) is (2H, 2W, C) with each pixel's two copies side by side
    np.testing.assert_array_equal(got[0], np.asarray(pallas).reshape(2 * h, 2 * w, c))


def test_conv1x1_matches_xla(rng):
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    w = rng.standard_normal((1, 1, 3, 64)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    for relu in (False, True):
        got = tconv.conv1x1(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                            relu=relu).numpy()
        want = jconv.conv1x1(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=relu)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
