"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Marked ``gpu``: they skip where CUDA is absent. On a machine with an H100 run
them from the repository root without the JAX conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

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
# the cascade's widths, and two of the first kernel's
TEMPLATE_PAIRS = [(128, 128), (64, 128), (128, 64), (32, 64), (16, 32), (32, 32), (24, 24),
                  (3, 24), (16, 16), (3, 16), (32, 16), (16, 3), (24, 3), (256, 24), (5, 7)]


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


@pytest.mark.parametrize("pair", TEMPLATE_PAIRS, ids=str)
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


def test_sharded_engines_on_one_card_match_single_device():
    """Four row shards on cuda:0: the slab-in-shard cascade against the
    single-card slab engine at the same slab size (global slab boundaries
    coincide; float32 order only), and the per-conv cascade against the plain
    engine, both at the cascade bar of 40 dB; 5 stages x 4 shards halo
    launches for the first."""
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

    before = kc.halo_exchange_rows.launches
    sharded = WCTEngine(mode="16x", space=4, slab_rows=288, devices=["cuda:0"] * 4).stylize(tall, s)
    assert kc.halo_exchange_rows.launches - before == 5 * 4
    assert psnr(sharded, WCTEngine(mode="16x", slab_rows=288).stylize(tall, s)) >= 40.0
    per_conv = WCTEngine(mode="16x", space=4, devices=["cuda:0"] * 4).stylize(c, s)
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
    Every shard's extended map equals the plain exchange's, exactly."""
    from collaborative_distillation_tpu_torch.parallel import spatial as tsp
    shards = [_rand(gen, 1, h, 37, 16) for h in rows]
    got = tsp.halo_exchange_rows(shards)
    for d, x in enumerate(shards):
        top = shards[d - 1][:, -1:] if d else (x[:, 1:2] if x.shape[1] > 1 else shards[1][:, :1])
        bot = (shards[d + 1][:, :1] if d < len(rows) - 1 else
               (x[:, -2:-1] if x.shape[1] > 1 else shards[d - 1][:, -1:]))
        assert torch.equal(got[d], kc.halo_exchange_rows.plain(x, top, bot, 1))


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
