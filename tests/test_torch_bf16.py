"""bfloat16 inference in the PyTorch port against the reference's bf16 paths.

The kernels' plain versions (on the CPU) against the Pallas kernels in
interpret mode with bf16 inputs: the conv3x3 (``conv3x3_tiled``,
``conv3x3_lane128``) and the 1x1 (``conv1x1_lane128``) within one bf16 ulp
elementwise, |port - jax| <= 2^-7 |jax| with a floor of 1e-3 max|jax|: both
sum exact bf16 products in float32, in another order, and round once, so a
sum within that of a rounding boundary may round the other way. Pool and
upsample exactly. A bf16 encoder and decoder stage against the reference's
XLA path, which rounds twice (the conv to bf16, then + a bf16 bias): err /
max|ref| < 2e-2, the bound ``tests/test_pallas_conv.py`` holds its bf16
kernel to against XLA. The cascade is chaotic in bf16 (its per-stage ``eigh``
rotates eigenvectors of near-degenerate spectra), so whole cascades are held
to float32 as the reference's own bf16 tests hold them, and to the
reference's own bf16-vs-f32 reading.

Every input comes from numpy with a seed and is rounded to bf16 in one place
(:func:`_bf16`).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from collaborative_distillation_tpu.models import decoder_spec, encoder_spec, init_params
from collaborative_distillation_tpu.models import vgg as jvgg
from collaborative_distillation_tpu.models.packed_vgg import packed_wct_apply
from collaborative_distillation_tpu.models.zoo import load_pyramid as jax_load_pyramid
from collaborative_distillation_tpu.ops.pallas.conv import (conv1x1_lane128, conv3x3_lane128,
                                                            conv3x3_tiled, make_pad_columns,
                                                            supported)
from collaborative_distillation_tpu.ops.pallas.pool import packed_pool_lane, packed_upsample_lane
from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine

import torch

from collaborative_distillation_tpu_torch.cli import stylize as tstylize
from collaborative_distillation_tpu_torch.data import native_codec as tnc
from collaborative_distillation_tpu_torch.data.png import decode_png, encode_png
from collaborative_distillation_tpu_torch.models.vgg import apply_decoder, apply_encoder
from collaborative_distillation_tpu_torch.ops import conv as tconv
from collaborative_distillation_tpu_torch.ops import cuda as kc
from collaborative_distillation_tpu_torch.ops import wct_transform as tw
from collaborative_distillation_tpu_torch.utils.params import params_from_jax, pyramid_from_jax
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine, stylize_cascade_fn

BF16 = torch.bfloat16
PAIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "collaborative_distillation_tpu_torch", "data", "photo_pair_512.npz")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a: np.ndarray):
    """The one rounding of a float array to bf16: the numpy array of the
    rounded values (float32, exact) for JAX, and the bf16 tensor for the port."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16)
    return t.float().numpy(), t


def _misses(got: np.ndarray, want: np.ndarray) -> int:
    """Elements more than one bf16 ulp from ``want`` (2^-7 |want|, floor 1e-3
    max|want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = np.maximum(np.abs(want) * 2.0 ** -7, 1e-3 * np.abs(want).max())
    return int((np.abs(got - want) > bound).sum())


def _psnr(a, b) -> float:
    return float(10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2)))


def _conv_inputs(rng, h, w, cin, cout):
    x, xt = _bf16(rng.standard_normal((1, h, w, cin)))
    wt, wtt = _bf16(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin))
    b = rng.standard_normal(cout).astype(np.float32)
    return (x, wt, b), (xt, wtt, torch.from_numpy(b))


# ---- the kernels' plain versions against the Pallas kernels (interpret mode) --------

@pytest.mark.parametrize("case", [  # (H, W, Cin, Cout): test_pallas_conv.py:292's, the
    (6, 64, 128, 128), (16, 16, 16, 32), (16, 16, 32, 64), (8, 32, 64, 16)],  # cascade's
    ids=str)
def test_conv3x3_bf16_plain_matches_pallas_tiled(rng, case):
    h, w, ci, co = case
    (x, wt, b), (xt, wtt, bt) = _conv_inputs(rng, h, w, ci, co)
    got = tconv.conv3x3(xt, wtt, bt, relu=True)
    assert got.dtype == BF16
    xk = jnp.asarray(x[0], jnp.bfloat16)
    want = conv3x3_tiled(xk, make_pad_columns(xk, 1),
                         jnp.asarray(wt.reshape(9, ci, co), jnp.bfloat16), jnp.asarray(b),
                         relu=True, block_h=2, block_w=min(w, 32), ci_tile=ci, co_tile=co,
                         interpret=True)
    assert want.dtype == jnp.bfloat16
    assert _misses(got[0].float().numpy(), want) == 0


@pytest.mark.parametrize("case", [(12, 32, 128, 128), (8, 16, 64, 64), (8, 32, 32, 64)],
                         ids=str)
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_bf16_plain_matches_pallas_lane128(rng, case, relu):
    h, w, ci, co = case
    (x, wt, b), (xt, wtt, bt) = _conv_inputs(rng, h, w, ci, co)
    got = kc.conv3x3_reflect_bf16.plain(xt, wtt, bt, relu)
    bh, staged = supported(h, w, ci, co, 2)
    xk = jnp.asarray(x[0], jnp.bfloat16)
    want = conv3x3_lane128(xk, make_pad_columns(xk, 1),
                           jnp.asarray(wt.reshape(9, ci, co), jnp.bfloat16), jnp.asarray(b),
                           relu=relu, block_h=bh, staged=staged, interpret=True)
    assert _misses(got[0].float().numpy(), want) == 0


def test_conv3x3_bf16_plain_takes_a_bf16_bias_and_none(rng):
    (x, wt, b), (xt, wtt, bt) = _conv_inputs(rng, 5, 7, 3, 24)
    bb, bbt = _bf16(b)
    with_b = kc.conv3x3_reflect_bf16.plain(xt, wtt, bbt, False)
    # the bf16 bias is added in float32: the same as its float32 values
    assert torch.equal(with_b, kc.conv3x3_reflect_bf16.plain(xt, wtt, torch.from_numpy(bb),
                                                               False))
    none = kc.conv3x3_reflect_bf16.plain(xt, wtt, None, False)
    zero = kc.conv3x3_reflect_bf16.plain(xt, wtt, torch.zeros(24), False)
    assert torch.equal(none, zero) and none.dtype == BF16
    # bf16 halo rows are taken (the per-conv sharded path in bf16): the
    # float32 halo conv of the upcast values, rounded once; a row that is
    # not one (N, 1, W, Cin) row of x's type is refused
    got = kc.conv3x3_reflect_bf16.plain(xt, wtt, None, True, top=xt[:, :1])
    want = kc.conv3x3_reflect.plain(xt.float(), wtt.float(), None, True, top=xt[:, :1].float())
    assert got.dtype == BF16 and torch.equal(got, want.to(BF16))
    with pytest.raises(ValueError, match="top row"):
        kc.conv3x3_reflect_bf16.plain(xt, wtt, None, True, top=xt[:, :2])


@pytest.mark.parametrize("pair", [(16, 16), (32, 32), (64, 64), (128, 128), (96, 96),
                                  (128, 32)], ids=str)
def test_conv1x1_bf16_plain_matches_pallas_lane128(rng, pair):
    ci, co = pair
    x, xt = _bf16(rng.standard_normal((8, 16, ci)))
    wt, wtt = _bf16(rng.standard_normal((ci, co)) / np.sqrt(ci))
    b = rng.standard_normal(co).astype(np.float32)
    got = kc.conv1x1_bias_bf16.plain(xt, wtt, torch.from_numpy(b), False)
    want = conv1x1_lane128(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16),
                           jnp.asarray(b), block_h=4, block_w=16, interpret=True)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert _misses(got.float().numpy(), want) == 0


@pytest.mark.parametrize("c", [16, 3])
def test_pool_and_upsample_bf16_equal_pallas(rng, c):
    x, xt = _bf16(rng.standard_normal((1, 8, 12, c)))
    pooled = tconv.max_pool_2x2(xt)
    up = tconv.upsample_nearest_2x(xt)
    assert pooled.dtype == up.dtype == BF16
    xk = jnp.asarray(x[0], jnp.bfloat16)
    jp = packed_pool_lane(xk, f=1, c=c, block_h=4, block_w=12, interpret=True)
    ju = packed_upsample_lane(xk, f=1, c=c, block_h=8, block_w=12, interpret=True)
    assert jp.dtype == ju.dtype == jnp.bfloat16
    np.testing.assert_array_equal(pooled[0].float().numpy(), np.asarray(jp, np.float32))
    np.testing.assert_array_equal(up[0].float().numpy(),
                                  np.asarray(ju, np.float32).reshape(16, 24, c))


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_wct_apply_folded_bf16_matches_packed_wct_apply(rng, alpha):
    """The bf16 engine's folded WCT: M and beta formed in float32, M in bf16,
    the product on the bf16 1x1 (reference: ``packed_wct_apply`` at f = 1
    through ``conv1x1_lane128``)."""
    c = 32
    x, xt = _bf16(rng.standard_normal((1, 8, 16, c)) * 2 + 1)
    q = np.linalg.qr(rng.standard_normal((c, c)))[0]
    t = (q * rng.uniform(0.5, 2.0, c)) @ q.T
    cm, sm = rng.standard_normal(c), rng.standard_normal(c)
    t, cm, sm = (a.astype(np.float32) for a in (t, cm, sm))
    got = tw.wct_apply_folded(xt, torch.from_numpy(t), torch.from_numpy(cm),
                              torch.from_numpy(sm), alpha)
    want = packed_wct_apply(jnp.asarray(x, jnp.bfloat16), 1, c, jnp.asarray(t), jnp.asarray(cm),
                            jnp.asarray(sm), alpha)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    # M is rounded to bf16 on both sides from float32 sums in another
    # order: an entry of M may round the other way, so a bf16 ulp of the
    # output's largest magnitude
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err <= 2.0 ** -7 * np.abs(np.asarray(want, np.float32)).max()


# ---- stages and cascades -------------------------------------------------------------

def test_bf16_encoder_and_decoder_stage_match_jax_xla(weights_root, rng):
    """Stage 3 of the shipped 16x students in bf16: the JAX bf16 params
    carried with ``params_from_jax`` (bf16 leaves stay bf16, bit for bit)."""
    jpyr = jax_load_pyramid("16x", weights_root, stages=(3,), dtype=jnp.bfloat16)[3]
    enc = params_from_jax(jax.tree.map(np.asarray, jpyr["enc"]))
    dec = params_from_jax(jax.tree.map(np.asarray, jpyr["dec"]))
    leaf = np.asarray(jpyr["enc"]["conv11"]["w"])
    assert enc["conv11"]["w"].dtype == BF16
    np.testing.assert_array_equal(enc["conv11"]["w"].float().numpy(), leaf.astype(np.float32))
    x, xt = _bf16(rng.random((1, 32, 48, 3)))
    espec, dspec = (pyramid_from_jax({3: jpyr})[3][k] for k in ("enc_spec", "dec_spec"))
    feats = apply_encoder(enc, xt, espec, aux=False)["out"]
    jfeats = jvgg.apply_encoder(jpyr["enc"], jnp.asarray(x, jnp.bfloat16), jpyr["enc_spec"])["out"]
    assert feats.dtype == BF16 and jfeats.dtype == jnp.bfloat16
    ref = np.asarray(jfeats, np.float32)
    assert np.abs(feats.float().numpy() - ref).max() / np.abs(ref).max() < 2e-2
    f, ft = _bf16(np.asarray(jfeats, np.float32))
    out = apply_decoder(dec, ft, dspec)["out"]
    jout = np.asarray(jvgg.apply_decoder(jpyr["dec"], jnp.asarray(f, jnp.bfloat16),
                                         jpyr["dec_spec"])["out"], np.float32)
    assert out.dtype == BF16
    assert np.abs(out.float().numpy() - jout).max() / np.abs(jout).max() < 2e-2


def _toy_pyramid(stages, key=0):
    """The reference test's toy pyramid (tests/test_engine.py), in numpy."""
    pyramid = {}
    k = jax.random.key(key)
    for s in stages:
        k, k1, k2 = jax.random.split(k, 3)
        espec = encoder_spec("16x", s, aux=True)
        dspec = decoder_spec("16x", s)
        pyramid[s] = {"enc_spec": espec, "dec_spec": dspec,
                      "enc": jax.tree.map(np.asarray, init_params(espec, k1)),
                      "dec": jax.tree.map(np.asarray, init_params(dspec, k2))}
    return pyramid


def test_bf16_cascade_close_to_f32(rng):
    """tests/test_engine.py::test_bf16_cascade_close_to_f32 on the port:
    ``stylize_cascade_fn`` with bf16 params and maps (statistics in
    float32), 64^2, stages (2, 1), mean |bf16 - f32| < 0.05, output bf16."""
    stages = (2, 1)
    pyr32 = pyramid_from_jax(_toy_pyramid(stages))
    pyr16 = pyramid_from_jax(_toy_pyramid(stages), dtype=BF16)
    content = rng.random((1, 64, 64, 3), dtype=np.float32)
    style = rng.random((1, 64, 64, 3), dtype=np.float32)
    f = stylize_cascade_fn(pyr32, stages=stages)
    out32 = f(pyr32, torch.from_numpy(content), torch.from_numpy(style), 1.0)
    out16 = f(pyr16, _bf16(content)[1], _bf16(style)[1], 1.0)
    assert out16.dtype == BF16
    diff = (out16.float() - out32).abs()
    assert float(diff.mean()) < 0.05


def test_bf16_full_cascade_pinned_floor(weights_root):
    """tests/test_engine.py::test_bf16_full_cascade_pinned_floor on the
    port: the shipped 16x weights, 128^2 noise of seed 7, the bf16 engine
    against the float32 one above 12 dB (read on the CPU: 18.18 dB; the
    reference's own floor calibration read 17.6)."""
    rng = np.random.default_rng(7)
    c = rng.random((128, 128, 3), dtype=np.float32)
    s = rng.random((128, 128, 3), dtype=np.float32)
    o32 = WCTEngine(mode="16x", weights_root=weights_root, device="cpu").stylize(c, s)
    o16 = WCTEngine(mode="16x", weights_root=weights_root, device="cpu",
                    dtype=BF16).stylize(c, s)
    assert o16.dtype == np.float32 and o16.shape == c.shape
    assert _psnr(o16, o32) > 12.0


@pytest.fixture(scope="module")
def crop():
    with np.load(PAIR) as d:
        return d["content"][:256, :256], d["style"][:256, :256]


def test_bf16_cascade_within_3_db_of_jax_bf16_against_f32(weights_root, crop):
    """On the 256^2 crop of the photo pair: PSNR(port bf16, JAX f32) is no
    more than 3 dB below PSNR(JAX bf16, JAX f32), both read here. Read on
    the CPU: JAX bf16 vs JAX f32 37.01 dB, port bf16 vs JAX f32 39.14 dB
    (port bf16 vs JAX bf16 38.70 dB)."""
    c, s = crop
    j32 = np.asarray(JaxEngine(mode="16x", weights_root=weights_root).stylize(c, s),
                     np.float32)
    j16 = np.asarray(JaxEngine(mode="16x", weights_root=weights_root,
                               dtype=jnp.bfloat16).stylize(c, s), np.float32)
    p16 = WCTEngine(mode="16x", weights_root=weights_root, device="cpu",
                    dtype=BF16).stylize(c, s)
    jax_db, port_db = _psnr(j16, j32), _psnr(p16, j32)
    assert port_db >= jax_db - 3.0, (port_db, jax_db)


def test_bf16_slab_path_no_farther_from_f32_than_plain(weights_root, crop):
    """The fused UHD slab path in bf16 (704 rows, slabs of 288), with conv0
    run as on the plain path (``packed=False``), stands no more than 1 dB
    farther from the float32 plain output than the plain bf16 output does."""
    c, s = crop
    tall = np.concatenate([c, c[::-1], c])[:704, :64]
    sty = s[:64, :64]
    ref = WCTEngine(mode="16x", weights_root=weights_root, device="cpu").stylize(tall, sty)
    plain = WCTEngine(mode="16x", weights_root=weights_root, device="cpu",
                      dtype=BF16).stylize(tall, sty)
    slab_eng = WCTEngine(mode="16x", weights_root=weights_root, device="cpu", dtype=BF16,
                         slab_rows=288, packed=False)
    slab = slab_eng.stylize(tall, sty)
    assert slab.shape == tall.shape
    assert _psnr(slab, ref) >= _psnr(plain, ref) - 1.0
    # the uint8 streamed tail converts from float32, as the whole cascade
    slab_eng.stream_min_pix = 1
    u8 = slab_eng.stylize((tall * 255).astype(np.uint8), sty, as_uint8=True)
    assert u8.dtype == np.uint8 and u8.shape == tall.shape


def test_bf16_folded_slab_path_no_farther_from_f32_than_reference_folded(weights_root, crop):
    """The default bf16 slab path folds conv0 into conv1_1 and rounds the
    folded weights and bias to bf16 once, as the reference's packed engine
    does; that rounding costs accuracy against float32 in both packages
    (``tools/fold_accuracy.py``, four threads: port 50.12 dB unfolded, 47.69
    folded; reference 49.44 and 44.71). The port's folded bf16 slab path
    stands no more than 1 dB farther from the float32 plain output than the
    reference's folded bf16 slab path does."""
    c, s = crop
    tall = np.concatenate([c, c[::-1], c])[:704, :64]
    sty = s[:64, :64]
    ref = WCTEngine(mode="16x", weights_root=weights_root, device="cpu").stylize(tall, sty)
    jax_folded = np.asarray(JaxEngine(mode="16x", weights_root=weights_root, dtype=jnp.bfloat16,
                                      slab_rows=288, packed=True).stylize(tall, sty), np.float32)
    eng = WCTEngine(mode="16x", weights_root=weights_root, device="cpu", dtype=BF16,
                    slab_rows=288)
    assert eng.slab.packed
    assert _psnr(eng.stylize(tall, sty), ref) >= _psnr(jax_folded, ref) - 1.0


def test_engine_external_pyramid_cast_to_dtype(rng):
    """tests/test_engine.py::test_engine_external_pyramid_cast_to_dtype on
    the port: an external float32 pyramid is cast to bf16."""
    stages = (2, 1)
    eng = WCTEngine(mode="16x", stages=stages, pyramid=pyramid_from_jax(_toy_pyramid(stages)),
                    dtype=BF16, slab_rows=32, device="cpu")
    for k in stages:
        assert all(t.dtype == BF16 for leaf in eng.pyramid[k]["enc"].values()
                   for t in leaf.values())
    c = rng.random((64, 48, 3), dtype=np.float32)
    sty = rng.random((64, 48, 3), dtype=np.float32)
    out = eng.stylize(c, sty)
    assert out.shape == c.shape and np.isfinite(out).all()
    dev = eng.stylize_device(torch.from_numpy(c), torch.from_numpy(sty))
    assert dev.dtype == BF16 and dev.shape == (1, 64, 48, 3)


def test_bf16_refusals(weights_root):
    """The bf16 engines that were refused before (``space`` with and
    without ``slab_rows``, ``pwct=True``) construct and run, in bf16 on the
    device; what stays refused is another dtype than float32 and bfloat16
    (and photo-WCT on the slab and sharded paths, as in float32)."""
    img = np.random.default_rng(0).random((64, 32, 3), dtype=np.float32)
    plain = WCTEngine(mode="16x", weights_root=weights_root, device="cpu", dtype=BF16)
    for kw in (dict(space=2, devices=["cpu"] * 2),
               dict(space=4, slab_rows=288, devices=["cpu"] * 4)):
        eng = WCTEngine(pyramid=plain.pyramid, device="cpu", dtype=BF16, **kw)
        out = eng.stylize_device(torch.from_numpy(img), torch.from_numpy(img))
        assert out.dtype == BF16 and bool(torch.isfinite(out.float()).all())
        with pytest.raises(ValueError, match="only supported on the plain per-stage path"):
            eng.stylize(img, img, pwct=True)
    out = plain.stylize_device(torch.from_numpy(img), torch.from_numpy(img), pwct=True)
    assert out.dtype == BF16 and out.shape == (1, 64, 32, 3)
    for dtype in (torch.float16, torch.float64, "bfloat16"):
        with pytest.raises(ValueError, match="dtype"):
            WCTEngine(mode="16x", weights_root=weights_root, device="cpu", dtype=dtype)


def test_cli_bf16_writes_the_bf16_engines_pixels(weights_root, crop, tmp_path, monkeypatch):
    """``cli.stylize --bf16`` (refused before bf16 had kernels) writes the
    bf16 engine's uint8 pixels (PNG: no codec, so nothing lossy between)."""
    monkeypatch.setattr(tnc, "_lib", None)
    monkeypatch.setattr(tnc, "_reason", "native codec unavailable: forced off")
    c, s = (a[:64, :64] for a in crop)
    for name, img in (("content", c), ("style", s)):
        (tmp_path / name).mkdir()
        (tmp_path / name / "a.png").write_bytes(encode_png(img))
    args = ["--mode", "16x", "--contentPath", str(tmp_path / "content"), "--stylePath",
            str(tmp_path / "style"), "--outf", str(tmp_path / "out"), "--log_mark", "b",
            "--device", "cpu", "--bf16", "--weights_root", weights_root]
    assert tstylize.main(args) == 0
    files = [f for f in os.listdir(tmp_path / "out") if f.startswith("b_mode")]
    assert len(files) == 1 and files[0].endswith(".png")   # no libjpeg needed
    got = decode_png((tmp_path / "out" / files[0]).read_bytes())
    want = WCTEngine(mode="16x", weights_root=weights_root, device="cpu",
                     dtype=BF16).stylize(c, s, as_uint8=True)
    np.testing.assert_array_equal(got, want)


def test_bf16_kernels_count_and_refuse_cpu_tensors():
    assert all(k.launches == 0 for k in kc.BF16_KERNELS)
    assert all(callable(k.plain) for k in kc.BF16_KERNELS)
    x = torch.zeros(1, 4, 4, 8, dtype=BF16)
    for call in (lambda: kc.conv3x3_reflect(x, torch.zeros(3, 3, 8, 4, dtype=BF16), None, True),
                 lambda: kc.conv1x1_bias(x, torch.zeros(8, 4, dtype=BF16), None, False),
                 lambda: kc.max_pool_2x2(x), lambda: kc.upsample_nearest_2x(x)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert all(k.launches == 0 for k in kc.BF16_KERNELS + kc.KERNELS)
