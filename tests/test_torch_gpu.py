"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Marked ``gpu``: they skip where CUDA is absent. On a machine with an H100 run
them from the repository root without the JAX conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import pytest
import torch

from collaborative_distillation_tpu_torch.ops import cuda as kc
from collaborative_distillation_tpu_torch.ops.wct_transform import feature_stats

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


@pytest.mark.parametrize("case", [(1000, 24, True), (4097, 128, True), (777, 64, False),
                                  (300, 512, False), (1, 3, True), (65, 16, True)], ids=str)
def test_sum_gram_kernel_matches_plain(gen, case):
    # tolerance: float32 sums over P rows in another order
    p, c, shifted = case
    x = _rand(gen, p, c) * 4 + 10
    shift = x[:64].mean(0) if shifted else None
    (s, g), (sp, gp) = kc.sum_gram(x, shift), kc.sum_gram.plain(x, shift)
    torch.cuda.synchronize()
    assert float((g - gp).abs().max()) <= 2e-5 * float(gp.abs().max())
    xs = x if shift is None else x - shift
    assert float((s - sp).abs().max()) <= 2e-5 * float(xs.abs().sum(0).max())
    s2, g2 = kc.sum_gram(x, shift)
    assert torch.equal(s, s2) and torch.equal(g, g2)  # fixed-order reduction


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
