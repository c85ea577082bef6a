"""The PyTorch port's ``WCTEngine`` surface against the reference engine, on
the CPU: alpha, num_run, batches, uint8 I/O, the style cache, style blends,
stylize_device and the device rule. Images are 64x64 crops of the
docs/examples photo pair; PSNR >= 40 dB is the cascade parity bar (see
tests/test_torch_engine.py).
"""

import os

import numpy as np
import pytest
from PIL import Image

import jax

from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine

import torch

from collaborative_distillation_tpu_torch.utils.params import pyramid_from_jax
from collaborative_distillation_tpu_torch.wct import engine as tengine
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "docs", "examples")
PSNR_MIN_DB = 40.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2))


@pytest.fixture(scope="module")
def images():
    ims = [np.asarray(Image.open(os.path.join(EXAMPLES, n)).convert("RGB")
                      .resize((128, 128), Image.BICUBIC), np.uint8)
           for n in ("in1+in1_16x.jpg", "in3+in2_16x.jpg")]
    return {"c": ims[0][:64, :64], "s": ims[1][32:96, 32:96], "c2": ims[0][64:, 64:],
            "s2": ims[1][:64, 64:]}


def _f(u8):
    return u8.astype(np.float32) / 255.0


@pytest.fixture(scope="module")
def engines(weights_root):
    je = JaxEngine(mode="16x", weights_root=weights_root)
    pyr = {k: {**v, "enc": jax.tree.map(np.asarray, v["enc"]),
               "dec": jax.tree.map(np.asarray, v["dec"])} for k, v in je.pyramid.items()}
    return je, WCTEngine(pyramid=pyramid_from_jax(pyr), device="cpu")


def test_alpha_zero_and_num_run_match_reference(images, engines):
    je, te = engines
    c, s = _f(images["c"]), _f(images["s"])
    a0 = te.stylize(c, s, alpha=0.0)
    assert _psnr(a0, je.stylize(c, s, alpha=0.0)) >= PSNR_MIN_DB
    # alpha=0 is the students' reconstruction, not the identity
    assert 0.0 < np.abs(a0 - c).mean() < 0.2
    two = te.stylize(c, s, alpha=0.6, num_run=2)
    assert _psnr(two, je.stylize(c, s, alpha=0.6, num_run=2)) >= PSNR_MIN_DB
    assert np.abs(two - te.stylize(c, s, alpha=0.6)).mean() > 1e-3


def test_alpha_as_tensor(images, engines):
    _, te = engines
    c, s = _f(images["c"]), _f(images["s"])
    np.testing.assert_array_equal(te.stylize(c, s, alpha=torch.tensor(0.5)),
                                  te.stylize(c, s, alpha=0.5))


def test_batch_is_per_image(images, engines):
    """N=2 content with N=2 styles: each pair as if stylized alone."""
    je, te = engines
    c = np.stack([_f(images["c"]), _f(images["c2"])])
    s = np.stack([_f(images["s"]), _f(images["s2"])])
    got = te.stylize(c, s)
    assert got.shape == (2, 64, 64, 3)
    assert _psnr(got, je.stylize(c, s)) >= PSNR_MIN_DB
    # batched and single convs sum in other orders; eigh carries that to the
    # cascade's reordering floor, not to bit equality
    for i in range(2):
        assert _psnr(got[i], te.stylize(c[i], s[i])) >= PSNR_MIN_DB


def test_uint8_in_and_out(images, engines):
    je, te = engines
    got = te.stylize(images["c"], images["s"], as_uint8=True)
    want = je.stylize(images["c"], images["s"], as_uint8=True, transport="rgb")
    assert got.dtype == np.uint8 and got.shape == (64, 64, 3)
    assert _psnr(got / 255.0, want / 255.0) >= PSNR_MIN_DB
    # round half up of the float output
    f = te.stylize(images["c"], images["s"])
    np.testing.assert_array_equal(got, (np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8))


def test_style_cache_hit_and_invalidate(images, engines, monkeypatch):
    _, te = engines
    c, s = _f(images["c"]), _f(images["s"])
    first = te.stylize(c, s, style_key="blue")
    assert {k[1] for k in te._style_cache} >= {"blue"}
    calls = []
    real = tengine.stage_style_stats
    monkeypatch.setattr(tengine, "stage_style_stats",
                        lambda *a: calls.append(1) or real(*a))
    # a hit reuses the cached statistics even for a different style image
    hit = te.stylize(c, _f(images["s2"]), style_key="blue")
    assert not calls
    np.testing.assert_array_equal(hit, first)
    te.invalidate_style("blue")
    assert not any(k[1] == "blue" for k in te._style_cache)
    te.stylize(c, s, style_key="blue")
    assert len(calls) == len(te.stages)


def test_style_cache_is_bounded(images, engines, monkeypatch):
    _, te = engines
    monkeypatch.setattr(tengine, "STYLE_CACHE_MAX", 3)
    for i in range(3):
        te.stylize(_f(images["c"])[:32, :32], _f(images["s"])[:16 + 16 * i, :32],
                   style_key=f"k{i}")
    assert len(te._style_cache) == 3


def test_blend_of_one_style_is_that_style(images, engines):
    _, te = engines
    c, s = _f(images["c"]), _f(images["s"])
    np.testing.assert_allclose(te.stylize_multi(c, [s]), te.stylize(c, s), atol=1e-5)
    key, proxy = te.blend_styles([s, _f(images["s2"])], [3, 1], style_keys=["a", "b"])
    assert key == "blend:a:0.7500+b:0.2500" and proxy.shape == (16, 16, 3)
    out = te.stylize(c, proxy, style_key=key)
    assert np.isfinite(out).all()
    with pytest.raises(ValueError):
        te.blend_styles([])
    with pytest.raises(ValueError):
        te.blend_styles([s], [-1])


def test_stylize_device_matches_stylize(images, engines):
    _, te = engines
    c, s = _f(images["c"])[:50, :40], _f(images["s"])
    out = te.stylize_device(torch.from_numpy(c), torch.from_numpy(s))
    assert isinstance(out, torch.Tensor) and out.shape == (1, 50, 40, 3)
    np.testing.assert_array_equal(out[0].numpy(), te.stylize(c, s))


def test_engine_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WCTEngine()
    with pytest.raises(RuntimeError):
        WCTEngine(device="cuda")
    with pytest.raises(ValueError):
        WCTEngine(device="meta")
    with pytest.raises(ValueError):
        WCTEngine(device="cpu", method="svd")
    # the single-card UHD path, the row-sharded one and the transports are
    # ported, with the reference's validation; packing (a TPU lane layout)
    # and the choice of halo implementation have no counterpart
    assert WCTEngine(device="cpu", slab_rows=256).slab.slab_rows == 256
    assert WCTEngine(device="cpu", transport="yuv420").transport == "yuv420"
    with pytest.raises(ValueError, match="transport"):
        WCTEngine(device="cpu", transport="cmyk")
    for kw in ({"packed": True}, {"halo": "pallas"}):
        with pytest.raises(TypeError):
            WCTEngine(device="cpu", **kw)
    # row shards want one CUDA device each unless the caller lists devices
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="needs 2 devices"):
            WCTEngine(device="cpu", space=2)
    assert WCTEngine(device="cpu", space=2, devices=["cpu"] * 2).space == 2
    with pytest.raises(ValueError, match="space > 1"):
        WCTEngine(device="cpu", devices=["cpu"])
