"""bfloat16 on the port's sharded paths and in photo-WCT, on the CPU, against
the port's single-card bf16 path and the reference package's bf16 functions
of the same names (shards on ``devices=["cpu"] * 4``, the reference under
``shard_map`` on the virtual CPU mesh).

Tolerances, each stated at its test:

* a bf16 halo conv (``conv3x3_halo`` on bf16 shards) against the port's
  unsharded plain bf16 conv on the same rows: one bf16 ulp, 2^-7 |plain|
  with a floor of 1e-3 max|plain| (both sum exact products in float32, in
  another order, and round once);
* against the reference's ``conv3x3_halo`` in bf16: 2e-2 of max|ref|. Its
  per-conv path convolves through XLA, which rounds twice (the conv to bf16,
  then + a bf16 bias); the port rounds once;
* whole bf16 cascades are chaotic against each other (a bf16 ulp flipped in
  one conv moves a per-stage ``eigh``): they are held in PSNR on real
  content (crops of the photo pair) to the port's single-card bf16 path, to
  the reference's bf16 engine of the same path and to its float32 engine,
  with floors a few dB under what was read here (stated at each test).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from collaborative_distillation_tpu.models import decoder_spec, encoder_spec, init_params
from collaborative_distillation_tpu.models import vgg as jvgg
from collaborative_distillation_tpu.ops import conv as jconv
from collaborative_distillation_tpu.parallel import spatial as jsp
from collaborative_distillation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine

import torch

from collaborative_distillation_tpu_torch.cli import stylize as tstylize
from collaborative_distillation_tpu_torch.data import native_codec as tnc
from collaborative_distillation_tpu_torch.data.png import decode_png, encode_png
from collaborative_distillation_tpu_torch.models.vgg import (apply_decoder, apply_decoder_pwct,
                                                             apply_encoder)
from collaborative_distillation_tpu_torch.ops import cuda as kc
from collaborative_distillation_tpu_torch.ops import precision
from collaborative_distillation_tpu_torch.ops.cuda import conv as kconv
from collaborative_distillation_tpu_torch.ops.wct_transform import wct_transform
from collaborative_distillation_tpu_torch.parallel import spatial as tsp
from collaborative_distillation_tpu_torch.parallel.mesh import make_mesh
from collaborative_distillation_tpu_torch.utils.params import (params_from_jax,
                                                               pyramid_from_jax, spec_from_jax)
from collaborative_distillation_tpu_torch.wct import slab as tslab
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

BF16 = torch.bfloat16
SPEC = P(None, "space", None, None)
PAIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "collaborative_distillation_tpu_torch", "data", "photo_pair_512.npz")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(space=4, data=1)


def _bf16(a: np.ndarray):
    """The one rounding of a float array to bf16: the rounded values as a
    float32 numpy array (exact) for the reference, and the bf16 tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF16)
    return t.float().numpy(), t


def _misses(got, want) -> int:
    """Elements more than one bf16 ulp from ``want`` (2^-7 |want|, floor
    1e-3 max|want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = np.maximum(np.abs(want) * 2.0 ** -7, 1e-3 * np.abs(want).max())
    return int((np.abs(got - want) > bound).sum())


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _psnr(a, b) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(1.0 / mse))


def _split(t: torch.Tensor, rows) -> list[torch.Tensor]:
    return [p.contiguous() for p in t.split(list(rows), dim=1)]


def _join(shards) -> np.ndarray:
    return torch.cat(shards, dim=1).float().numpy()


def _jbf16(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _conv_inputs(rng, n, h, w, cin, cout):
    x, xt = _bf16(rng.standard_normal((n, h, w, cin)))
    wt, wtt = _bf16(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin))
    b, bt = _bf16(rng.standard_normal(cout))
    return (x, wt, b), (xt, wtt, bt)


# ---- the bf16 halo conv ------------------------------------------------------------

# (N, W, Cin, Cout, relu, shard rows): one-row shards (both neighbours' rows,
# or the opposite one's at a global edge), unequal heights, N = 2, odd W,
# Cin 3, W = 1
HALO_CASES = [(1, 7, 3, 16, True, (1, 1, 1, 1)), (2, 9, 16, 16, True, (5, 3, 1, 7)),
              (2, 5, 16, 3, False, (1, 6)), (1, 33, 32, 64, True, (2, 2, 2, 4)),
              (2, 4, 3, 24, True, (1, 1, 1, 2)), (1, 1, 24, 8, False, (3, 3, 3, 5)),
              (1, 6, 64, 128, True, (16, 16, 16, 32))]


@pytest.mark.parametrize("case", HALO_CASES, ids=str)
def test_bf16_halo_conv_rows_equal_the_unsharded_conv(rng, case):
    """bf16 shards put together equal the whole bf16 map's plain conv
    within one bf16 ulp, and the reference's XLA conv in bf16 within 2e-2
    of its largest value; the shards and their outputs stay bf16."""
    n, w, cin, cout, relu, rows = case
    (x, wt, b), (xt, wtt, bt) = _conv_inputs(rng, n, sum(rows), w, cin, cout)
    ys = tsp.conv3x3_halo(_split(xt, rows), [wtt] * len(rows), [bt] * len(rows), relu=relu)
    assert all(y.dtype == BF16 for y in ys)
    got = _join(ys)
    whole = kconv.conv3x3_plain(xt, wtt, bt, relu)
    assert _misses(got, whole.float().numpy()) == 0
    want = jconv.conv3x3(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16),
                         jnp.asarray(b, jnp.bfloat16), relu=relu)
    assert want.dtype == jnp.bfloat16
    assert _rel(got, want) <= 2e-2


@pytest.mark.parametrize("case", [(1, 6, 5, 7, True, 4), (2, 5, 16, 3, False, 1),
                                  (2, 9, 3, 16, True, 2)], ids=str)
def test_bf16_halo_conv_equals_reference_conv3x3_halo_under_shard_map(rng, jax_mesh, case):
    """Four equal bf16 shards against the reference's per-shard
    ``conv3x3_halo`` in bf16 (2e-2 of max|ref|), one-row shards included."""
    n, w, cin, cout, relu, h = case
    (x, wt, b), (xt, wtt, bt) = _conv_inputs(rng, n, 4 * h, w, cin, cout)
    got = _join(tsp.conv3x3_halo(_split(xt, [h] * 4), [wtt] * 4, [bt] * 4, relu=relu))
    jw, jb = jnp.asarray(wt, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = jax.jit(shard_map(lambda xs: jsp.conv3x3_halo(xs, jw, jb, "space", relu=relu),
                             mesh=jax_mesh, in_specs=SPEC, out_specs=SPEC))(
        jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    assert _rel(got, want) <= 2e-2


@pytest.mark.parametrize("side", ["top", "bot", "both", "none"])
@pytest.mark.parametrize("h", [1, 2, 5])
def test_bf16_halo_rows_stand_above_and_below(rng, side, h):
    """One bf16 shard with explicit bf16 rows: the float32 conv of the
    concatenated map (W-only reflect pad) rounded once, within one ulp; a
    ``None`` side is the shard's own reflection row; with no rows the plain
    bf16 conv bit for bit. A row of another type is refused."""
    n, w, cin, cout = 2, 5, 3, 4
    (x, wt, b), (xt, wtt, bt) = _conv_inputs(rng, n, h, w, cin, cout)
    up, upt = _bf16(rng.standard_normal((n, 1, w, cin)))
    down, downt = _bf16(rng.standard_normal((n, 1, w, cin)))
    top = upt if side in ("top", "both") else None
    bot = downt if side in ("bot", "both") else None
    got = kconv.conv3x3_plain(xt, wtt, bt, True, top=top, bot=bot)
    assert got.dtype == BF16
    own_top, own_bot = (x[:, 1:2], x[:, -2:-1]) if h >= 2 else (x, x)
    ext = np.concatenate([up if top is not None else own_top, x,
                          down if bot is not None else own_bot], axis=1)
    ext = np.pad(ext, ((0, 0), (0, 0), (1, 1), (0, 0)), mode="reflect")
    want = np.maximum(np.asarray(jconv.conv2d(jnp.asarray(ext), jnp.asarray(wt),
                                              jnp.asarray(b))), 0)
    assert _misses(got.float().numpy(), _bf16(want)[0]) == 0
    if side == "none":
        assert torch.equal(got, kconv.conv3x3_plain(xt, wtt, bt, True))
    with pytest.raises(ValueError, match="top row is torch.float32"):
        kconv.conv3x3_plain(xt, wtt, bt, True, top=upt.float())


def test_bf16_halo_rows_reach_the_kernel_wrapper_which_wants_the_card(rng):
    """``conv3x3_reflect`` hands bf16 halo rows to the bf16 kernel's wrapper
    (no refusal left), which takes CUDA tensors only and counts nothing
    here; the refusal's text is gone from the port."""
    (_, _, _), (xt, wtt, bt) = _conv_inputs(rng, 1, 4, 5, 16, 16)
    for call in (lambda: kc.conv3x3_reflect(xt, wtt, bt, True, top=xt[:, :1]),
                 lambda: kc.conv3x3_reflect_bf16(xt, wtt, bt, True, bot=xt[:, :1])):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert kc.conv3x3_reflect_bf16.halo_launches == 0
    assert kc.conv3x3_reflect_bf16.launches == 0
    assert not hasattr(precision, "BF16_REFUSED")
    assert precision.__all__ == ["full_float32", "bf16_full_reduction"]


# ---- the per-conv path's layers in bf16 -------------------------------------------

def _jax_stage(kind, stage, seed):
    spec = (encoder_spec("16x", stage, aux=True) if kind == "enc"
            else decoder_spec("16x", stage))
    jparams = _jbf16(init_params(spec, jax.random.key(seed)))
    return spec, jparams, spec_from_jax(spec), params_from_jax(_np_tree(jparams))


@pytest.mark.parametrize("stage", [1, 2])
def test_bf16_encoder_spatial_matches_unsharded_and_reference(rng, jax_mesh, stage):
    """bf16 shards through every conv and pool of an encoder stage: the
    port's unsharded bf16 encoder and the reference's sharded one in bf16,
    each within 2e-2 of max|ref| (a one-ulp flip carried through later
    layers stays under it; 0.0 to 8e-3 read)."""
    jspec, jparams, spec, params = _jax_stage("enc", stage, 7)
    x, xt = _bf16(rng.random((1, 64, 24, 3)))
    outs = tsp.apply_encoder_spatial([params] * 4, _split(xt, [16] * 4), spec)
    whole = apply_encoder(params, xt, spec)
    for name in ("out", "relu11"):
        assert outs[name][0].dtype == BF16
        assert _rel(_join(outs[name]), whole[name].float().numpy()) <= 2e-2
    want = jax.jit(shard_map(
        lambda p, xs: jsp.apply_encoder_spatial(p, xs, jspec, "space")["out"],
        mesh=jax_mesh, in_specs=(P(), SPEC), out_specs=SPEC))(jparams,
                                                              jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    assert _rel(_join(outs["out"]), want) <= 2e-2


@pytest.mark.parametrize("stage", [2, 3])
def test_bf16_decoder_spatial_matches_unsharded_and_reference(rng, jax_mesh, stage):
    jspec, jparams, spec, params = _jax_stage("dec", stage, 11)
    f, ft = _bf16(np.maximum(rng.standard_normal((1, 16, 12, spec.layers[0].in_ch)), 0))
    got = tsp.apply_decoder_spatial([params] * 4, _split(ft, [4] * 4), spec)
    assert got[0].dtype == BF16
    whole = apply_decoder(params, ft, spec)["out"].float().numpy()
    assert _rel(_join(got), whole) <= 2e-2
    want = jax.jit(shard_map(lambda p, xs: jsp.apply_decoder_spatial(p, xs, jspec, "space"),
                             mesh=jax_mesh, in_specs=(P(), SPEC), out_specs=SPEC))(
        jparams, jnp.asarray(f, jnp.bfloat16))
    assert _rel(_join(got), want) <= 2e-2


@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_bf16_wct_transform_spatial_matches_unsharded_and_reference(rng, jax_mesh, alpha):
    """bf16 feature shards: float32 statistics summed over the shards, the
    folded apply in bf16 (``M`` bf16, ``beta`` float32). Against the port's
    unsharded bf16 ``wct_transform`` within one ulp and the reference's
    sharded one in bf16 within 2e-2 of max|ref| (the same T up to float32
    order; a bf16 ``M`` entry may round the other way)."""
    c = 16
    f, ft = _bf16(np.maximum(rng.standard_normal((1, 32, 12, c)) + 0.3, 0))
    s = np.maximum(rng.standard_normal((500, c)) + 0.2, 0).astype(np.float32)
    s_mean = torch.from_numpy(s.mean(0))
    s_cov = torch.from_numpy(np.cov(s, rowvar=False).astype(np.float32))
    got = tsp.wct_transform_spatial(_split(ft, [8] * 4), s_mean, s_cov, alpha)
    assert got[0].dtype == BF16
    whole = wct_transform(ft, s_mean, s_cov, alpha).float().numpy()
    assert _rel(_join(got), whole) <= 2e-2
    want = jax.jit(shard_map(lambda xs: jsp.wct_transform_spatial(
        xs, jnp.asarray(s_mean.numpy()), jnp.asarray(s_cov.numpy()), alpha, "space",
        32 * 12), mesh=jax_mesh, in_specs=SPEC, out_specs=SPEC))(jnp.asarray(f, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    assert _rel(_join(got), want) <= 2e-2


# ---- both sharded cascades on the toy pyramid ------------------------------------

def _toy(stages, seed):
    key = jax.random.key(seed)
    pyr = {}
    for s in stages:
        key, k1, k2 = jax.random.split(key, 3)
        espec, dspec = encoder_spec("16x", s, aux=True), decoder_spec("16x", s)
        pyr[s] = {"enc_spec": espec, "dec_spec": dspec,
                  "enc": _jbf16(init_params(espec, k1)), "dec": _jbf16(init_params(dspec, k2))}
    return pyr, pyramid_from_jax({k: {**v, "enc": _np_tree(v["enc"]),
                                      "dec": _np_tree(v["dec"])} for k, v in pyr.items()})


def test_bf16_per_conv_cascade_matches_reference(rng, jax_mesh):
    """``build_tiled_stylize_fn`` on bf16 shards of a bf16 toy pyramid
    (stages 2, 1) against the reference's sharded bf16 cascade and against
    the port's plain bf16 cascade with the same (summed) style statistics:
    mean |diff| < 0.02 (0.001 to 0.006 read), the bar
    tests/test_torch_bf16.py holds bf16 to float32 at, tightened."""
    stages = (2, 1)
    jp, tp = _toy(stages, 3)
    c, ct = _bf16(rng.random((1, 64, 32, 3)))
    s, st = _bf16(rng.random((1, 64, 32, 3)))
    fn = tsp.build_tiled_stylize_fn(tp, make_mesh(space=4, devices=["cpu"] * 4), stages=stages)
    stats = {k: tsp.feature_stats_psum(tsp.apply_encoder_spatial(
        [tp[k]["enc"]] * 4, _split(st, [16] * 4), tp[k]["enc_spec"])["out"]) for k in stages}
    assert all(m.dtype == torch.float32 and v.dtype == torch.float32 for m, v in stats.values())
    out = fn(_split(ct, [16] * 4), stats, 0.8)
    assert out[0].dtype == BF16
    got = _join(out)
    jparams = {k: {"enc": jp[k]["enc"], "dec": jp[k]["dec"]} for k in stages}
    want = np.asarray(jsp.build_tiled_stylize_fn(jp, jax_mesh, stages=stages)(
        jparams, jnp.asarray(c, jnp.bfloat16), jnp.asarray(s, jnp.bfloat16), 0.8), np.float32)
    img = ct
    for k in stages:
        p = tp[k]
        feats = apply_encoder(p["enc"], img, p["enc_spec"], aux=False)["out"]
        img = apply_decoder(p["dec"], wct_transform(feats, *stats[k], 0.8),
                            p["dec_spec"])["out"]
    for other in (want, img.float().numpy()):
        assert np.abs(got - other).mean() < 0.02


@pytest.mark.parametrize("halo", ["ppermute", "pallas"])
def test_bf16_tiled_slab_cascade_matches_reference(halo):
    """``build_tiled_slab_cascade`` on bf16 shards (``halo.cu``'s plain
    version on bf16 rows) against the reference's with either halo
    implementation (the Pallas one in interpret mode) in bf16, mean |diff|
    < 0.02 (0.002 to 0.01 read), and bit-equal to the port's single-card
    bf16 fused slab cascade at the same slab size."""
    stages = (2, 1)
    jp, tp = _toy(stages, 7)
    rng = np.random.default_rng(0)
    slab = tslab.SlabCascade(tp, stages=stages, slab_rows=32).slab_rows
    c, ct = _bf16(rng.random((1, 4 * slab, 24, 3)))
    s, st = _bf16(rng.random((1, 32, 24, 3)))
    fn = tsp.build_tiled_slab_cascade(tp, make_mesh(space=4, devices=["cpu"] * 4),
                                      stages=stages, slab_rows=slab)
    out = fn(_split(ct, [slab] * 4), st, 0.8)
    assert out[0].dtype == BF16
    got = _join(out)
    jfn, jparams = jsp.build_tiled_slab_cascade(jp, jax_make_mesh(space=4), stages=stages,
                                                slab_rows=slab, halo=halo)
    want = np.asarray(jfn(jparams, jnp.asarray(c, jnp.bfloat16), jnp.asarray(s, jnp.bfloat16),
                          0.8), np.float32)
    assert np.abs(got - want).mean() < 0.02
    single = tslab.build_fused_slab_cascade(tp, stages=stages, slab_rows=slab)(ct, st, 0.8)
    np.testing.assert_array_equal(got, single.float().numpy())


# ---- the engines on the photo pair (shipped 16x weights) --------------------------

@pytest.fixture(scope="module")
def photo():
    with np.load(PAIR) as d:
        return d["content"].astype(np.float32) / 255.0, d["style"].astype(np.float32) / 255.0


@pytest.fixture(scope="module")
def engines(weights_root):
    j32 = JaxEngine(mode="16x", weights_root=weights_root)
    j16 = JaxEngine(mode="16x", weights_root=weights_root, dtype=jnp.bfloat16)
    port = WCTEngine(mode="16x", weights_root=weights_root, device="cpu", dtype=BF16)
    return j32, j16, port


def test_bf16_per_conv_engine_on_the_photo_pair(engines, weights_root, photo):
    """``WCTEngine(dtype=bfloat16, space=4)`` on a 256 x 128 crop (rows a
    multiple of 16 x space, so the reference's sharded engine pads nothing):
    >= 30 dB from the port's plain bf16 engine (37.5 read), >= 28 dB from
    the reference's bf16 sharded engine (32.5 read), and no more than 3 dB
    farther from the reference's float32 engine than that engine's own bf16
    sharded output is (31.4 and 32.6 dB read)."""
    j32, _, port = engines
    c, s = photo[0][:256, :128], photo[1][:128, :128]
    eng = WCTEngine(pyramid=port.pyramid, device="cpu", dtype=BF16, space=4,
                    devices=["cpu"] * 4)
    got = eng.stylize(c, s)
    assert got.shape == c.shape and got.dtype == np.float32 and np.isfinite(got).all()
    dev = eng.stylize_device(torch.from_numpy(c), torch.from_numpy(s))
    assert dev.dtype == BF16
    jsp16 = np.asarray(JaxEngine(mode="16x", weights_root=weights_root, dtype=jnp.bfloat16,
                                 space=4).stylize(c, s), np.float32)
    f32 = np.asarray(j32.stylize(c, s), np.float32)
    assert _psnr(got, port.stylize(c, s)) >= 30.0
    assert _psnr(got, jsp16) >= 28.0
    assert _psnr(got, f32) >= _psnr(jsp16, f32) - 3.0


def test_bf16_slab_in_shard_engine_on_the_photo_pair(engines, weights_root, photo):
    """``WCTEngine(dtype=bfloat16, space=4, slab_rows=288)`` on 1152 x 32
    rows (four shards of one window each): bit-equal to the port's
    single-card bf16 slab engine (the same sums in the same order), >= 45
    dB from the reference's bf16 engine of the same path (49.5 read), and
    no more than 3 dB farther from the reference's float32 engine than that
    engine's own bf16 output is (49.7 and 51.1 dB read)."""
    j32, _, port = engines
    c, s = photo
    tall = np.concatenate([c, c[::-1], c])[:1152, :32]
    sty = s[:64, :64]
    eng = WCTEngine(pyramid=port.pyramid, device="cpu", dtype=BF16, space=4, slab_rows=288,
                    devices=["cpu"] * 4, packed=False)
    got = eng.stylize(tall, sty)
    assert got.shape == tall.shape and np.isfinite(got).all()
    single = WCTEngine(pyramid=port.pyramid, device="cpu", dtype=BF16, slab_rows=288,
                       packed=False)
    np.testing.assert_array_equal(got, single.stylize(tall, sty))
    jss = np.asarray(JaxEngine(mode="16x", weights_root=weights_root, dtype=jnp.bfloat16,
                               space=4, slab_rows=288, packed=False).stylize(tall, sty),
                     np.float32)
    f32 = np.asarray(j32.stylize(tall, sty), np.float32)
    assert _psnr(got, jss) >= 45.0
    assert _psnr(got, f32) >= _psnr(jss, f32) - 3.0


def test_bf16_stage3_encoder_with_argmax_and_pwct_decoder_match_reference(rng):
    """Photo-WCT's stage in bf16: the encoder with pool argmax against the
    reference's in bf16 (argmax maps equal where the pooled maps are; the
    features within 2e-2 of max|ref|: XLA's convs round twice), and the pwct
    decoder on the same features and the reference's indices within 2e-2.
    bf16 ties (8 bits of mantissa) go to the first maximum in both."""
    jes, jds = encoder_spec("16x", 3, aux=True), decoder_spec("16x", 3)
    jenc = _jbf16(init_params(jes, jax.random.key(3)))
    jdec = _jbf16(init_params(jds, jax.random.key(4)))
    enc, dec = params_from_jax(_np_tree(jenc)), params_from_jax(_np_tree(jdec))
    x, xt = _bf16(rng.random((1, 36, 44, 3)))
    got = apply_encoder(enc, xt, spec_from_jax(jes), aux=False, with_pool_argmax=True)
    want = jvgg.apply_encoder(jenc, jnp.asarray(x, jnp.bfloat16), jes, with_pool_argmax=True)
    assert got["out"].dtype == BF16 and want["out"].dtype == jnp.bfloat16
    assert _rel(got["out"].float().numpy(), want["out"]) <= 2e-2
    for p in (1, 2):
        assert got[f"pool{p}_hw"] == want[f"pool{p}_hw"]
        assert got[f"pool{p}_idx"].dtype == torch.int32
        # the maps pooled differ by XLA's second rounding, so a window's
        # maximum may move; most do not
        agree = np.mean(got[f"pool{p}_idx"].numpy() == np.asarray(want[f"pool{p}_idx"]))
        assert agree >= 0.9, (p, agree)
    f, ft = _bf16(rng.standard_normal(np.asarray(want["out"]).shape))
    idx = {k: v for k, v in want.items() if k.startswith("pool")}
    rec = apply_decoder_pwct(dec, ft, spec_from_jax(jds),
                             {k: torch.from_numpy(np.array(v)) if k.endswith("idx") else v
                              for k, v in idx.items()})
    j_rec = jvgg.apply_decoder_pwct(jdec, jnp.asarray(f, jnp.bfloat16), jds, idx)
    assert rec.dtype == BF16 and j_rec.dtype == jnp.bfloat16
    assert rec.shape == x.shape and (np.asarray(j_rec, np.float32) < 0).any()
    assert _rel(rec.float().numpy(), j_rec) <= 2e-2


def test_bf16_pwct_engine_on_the_photo_pair(engines, photo):
    """``stylize(pwct=True)`` on the bf16 engine, 128^2 content and 64^2
    style: >= 40 dB from the reference's bf16 photo-WCT (47.0 read), and no
    more than 3 dB farther from its float32 photo-WCT than that engine's
    own bf16 output is (47.9 and 48.6 dB read). On larger crops photo-WCT
    in bf16 stands ~12 dB from float32 in both packages (the unpool moves
    values to another maximum of a window that bf16 ties), so this crop is
    the one where the comparison can see a fault."""
    j32, j16, port = engines
    c, s = photo[0][:128, :128], photo[1][:64, :64]
    got = port.stylize(c, s, pwct=True)
    assert got.shape == c.shape and np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0
    j16_out = np.asarray(j16.stylize(c, s, pwct=True), np.float32)
    f32 = np.asarray(j32.stylize(c, s, pwct=True), np.float32)
    assert _psnr(got, j16_out) >= 40.0
    assert _psnr(got, f32) >= _psnr(j16_out, f32) - 3.0


# ---- the CLI -------------------------------------------------------------------

@pytest.mark.parametrize("slab_rows", [0, 288])
def test_cli_bf16_space_writes_the_bf16_sharded_engines_pixels(weights_root, photo, tmp_path,
                                                               monkeypatch, slab_rows):
    """``cli.stylize --bf16 --space 4 --devices cpu,cpu,cpu,cpu`` (with and
    without ``--slab_rows``) writes the bf16 sharded engine's uint8 pixels
    (PNG: no codec, so nothing lossy between); without ``--packed`` the CLI
    keeps conv0, so its engine is ``packed=False``."""
    monkeypatch.setattr(tnc, "_lib", None)
    monkeypatch.setattr(tnc, "_reason", "native codec unavailable: forced off")
    c = (photo[0][:576, :64] * 255).astype(np.uint8)
    s = (photo[1][:64, :64] * 255).astype(np.uint8)
    for name, img in (("content", c), ("style", s)):
        (tmp_path / name).mkdir()
        (tmp_path / name / "a.png").write_bytes(encode_png(img))
    args = ["--mode", "16x", "--contentPath", str(tmp_path / "content"), "--stylePath",
            str(tmp_path / "style"), "--outf", str(tmp_path / "out"), "--log_mark", "b",
            "--device", "cpu", "--bf16", "--space", "4", "--devices", "cpu,cpu,cpu,cpu",
            "--slab_rows", str(slab_rows), "--weights_root", weights_root]
    assert tstylize.main(args) == 0
    files = [f for f in os.listdir(tmp_path / "out") if f.startswith("b_mode")]
    assert len(files) == 1 and files[0].endswith(".png")
    got = decode_png((tmp_path / "out" / files[0]).read_bytes())
    eng = WCTEngine(mode="16x", weights_root=weights_root, device="cpu", dtype=BF16, space=4,
                    slab_rows=slab_rows, devices=["cpu"] * 4, packed=False)
    np.testing.assert_array_equal(got, eng.stylize(c, s, as_uint8=True))
    with pytest.raises(ValueError, match="needs 4 devices"):
        tstylize.main(args[:-6] + args[-4:])   # no --devices: a card per shard
