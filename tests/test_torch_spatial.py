"""The port's per-conv row-sharded cascade (``parallel/spatial.py``:
one-row halos at every conv, summed statistics) on ``devices=["cpu"] * 4``
against the unsharded port and against the reference package's functions of
the same names on the virtual CPU mesh, with the cases of
tests/test_spatial.py.

Tolerances, as tests/test_spatial.py holds them: encoders and decoders 1e-5,
statistics 1e-4; whole cascades on the random toy pyramid by the share of
pixels that ``eigh`` on near-degenerate covariances throws far (stated at
the test). The engine's output against the reference engine's: atol 3e-3.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from collaborative_distillation_tpu.models import (apply_decoder as jax_apply_decoder,
                                                   apply_encoder as jax_apply_encoder)
from collaborative_distillation_tpu.models.specs import decoder_spec, encoder_spec
from collaborative_distillation_tpu.models.vgg import init_params
from collaborative_distillation_tpu.ops import feature_stats as jax_feature_stats
from collaborative_distillation_tpu.parallel import spatial as jsp
from collaborative_distillation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine

import torch

from collaborative_distillation_tpu_torch.models.vgg import apply_decoder, apply_encoder
from collaborative_distillation_tpu_torch.ops.wct_transform import feature_stats
from collaborative_distillation_tpu_torch.parallel import spatial as tsp
from collaborative_distillation_tpu_torch.parallel.mesh import make_mesh
from collaborative_distillation_tpu_torch.utils.params import (params_from_jax,
                                                               pyramid_from_jax, spec_from_jax)
from collaborative_distillation_tpu_torch.wct import engine as tengine
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

ATOL = 3e-3
SPEC = P(None, "space", None, None)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(pyr):
    return {k: {**v, "enc": jax.tree.map(np.asarray, v["enc"]),
                "dec": jax.tree.map(np.asarray, v["dec"])} for k, v in pyr.items()}


def _toy_pyramid(stages, seed):
    key = jax.random.key(seed)
    pyr = {}
    for s in stages:
        key, k1, k2 = jax.random.split(key, 3)
        espec, dspec = encoder_spec("16x", s, aux=True), decoder_spec("16x", s)
        pyr[s] = {"enc_spec": espec, "dec_spec": dspec,
                  "enc": init_params(espec, k1), "dec": init_params(dspec, k2)}
    return pyr


def _cpu_mesh(space, data=1):
    return make_mesh(data=data, space=space, devices=["cpu"] * (data * space))


def _shards(x, n):
    return [p.contiguous() for p in torch.from_numpy(np.asarray(x)).chunk(n, dim=1)]


def _sharded_style_stats(pyramid, style_shards, stages):
    """{stage: (mean, cov)} of the style summed over its row shards, as the
    reference's sharded cascade takes them."""
    return {k: tsp.feature_stats_psum(tsp.apply_encoder_spatial(
        [pyramid[k]["enc"]] * len(style_shards), style_shards, pyramid[k]["enc_spec"])["out"])
        for k in stages}


def _join(shards):
    return torch.cat(shards, dim=1).numpy()


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(space=4, data=1)


@pytest.mark.parametrize("stage", [1, 2, 3, 5])
def test_tiled_encoder_equals_untiled(rng, jax_mesh, stage):
    """Neighbour rows at shard borders, reflection at the global ones,
    through every conv and pool: equal to the unsharded encoder, and to the
    reference's sharded one."""
    jspec = encoder_spec("16x", stage, aux=True)
    jparams = init_params(jspec, jax.random.key(7))
    spec, params = spec_from_jax(jspec), params_from_jax(jax.tree.map(np.asarray, jparams))
    x = rng.random((1, 128, 32, 3), dtype=np.float32)
    outs = tsp.apply_encoder_spatial([params] * 4, _shards(x, 4), spec)
    whole = apply_encoder(params, torch.from_numpy(x), spec)
    assert set(outs) == set(whole)
    for name in ("out", "relu11", "aux11"):
        np.testing.assert_allclose(_join(outs[name]), whole[name].numpy(), rtol=1e-5, atol=1e-5)
    want = shard_map(lambda p, xs: jsp.apply_encoder_spatial(p, xs, jspec, "space")["out"],
                     mesh=jax_mesh, in_specs=(P(), SPEC), out_specs=SPEC)(jparams, jnp.asarray(x))
    np.testing.assert_allclose(_join(outs["out"]), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jax_apply_encoder(jparams, jnp.asarray(x), jspec)["out"]),
                               whole["out"].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stage", [2, 4])
def test_tiled_decoder_equals_untiled(rng, jax_mesh, stage):
    jspec = decoder_spec("16x", stage)
    jparams = init_params(jspec, jax.random.key(8))
    spec, params = spec_from_jax(jspec), params_from_jax(jax.tree.map(np.asarray, jparams))
    down = 2 ** (stage - 1)
    x = rng.random((1, 128 // down, 16, jspec.layers[0].in_ch), dtype=np.float32)
    got = _join(tsp.apply_decoder_spatial([params] * 4, _shards(x, 4), spec))
    whole = apply_decoder(params, torch.from_numpy(x), spec)["out"].numpy()
    np.testing.assert_allclose(got, whole, rtol=1e-5, atol=1e-5)
    want = shard_map(lambda p, xs: jsp.apply_decoder_spatial(p, xs, jspec, "space"),
                     mesh=jax_mesh, in_specs=(P(), SPEC), out_specs=SPEC)(jparams, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jax_apply_decoder(jparams, jnp.asarray(x), jspec)["out"]),
                               whole, rtol=1e-5, atol=1e-5)


def test_single_row_shards_take_the_opposite_halo(rng):
    """Shards of one row (deep pyramid levels): the global reflection row is
    the other neighbour's, as the reference's ``halo_exchange_rows`` picks it.
    Shards of two rows take their own reflection rows at the global edges:
    ``None`` in the pair (the conv reads its own row), the reference's rows
    1 and H-2 once filled in."""
    jax_pair = shard_map(lambda xs: jsp.halo_exchange_rows(xs, "space"),
                         mesh=jax_make_mesh(space=4), in_specs=SPEC, out_specs=(SPEC, SPEC))
    x = rng.random((1, 4, 6, 5), np.float32)
    pairs = tsp.halo_rows(_shards(x, 4))
    want_top, want_bot = jax_pair(jnp.asarray(x))
    np.testing.assert_array_equal(_join([t for t, _ in pairs]), want_top)
    np.testing.assert_array_equal(_join([b for _, b in pairs]), want_bot)
    x2 = rng.random((1, 8, 6, 5), np.float32)
    xs = _shards(x2, 4)
    two = tsp.halo_rows(xs)
    assert [(t is None, b is None) for t, b in two] == [(True, False), (False, False),
                                                        (False, False), (False, True)]
    want_top, want_bot = jax_pair(jnp.asarray(x2))
    np.testing.assert_array_equal(
        _join([xs[d][:, 1:2] if t is None else t for d, (t, _) in enumerate(two)]), want_top)
    np.testing.assert_array_equal(
        _join([xs[d][:, -2:-1] if b is None else b for d, (_, b) in enumerate(two)]), want_bot)


def test_summed_stats_match_global(rng, jax_mesh):
    x = rng.standard_normal((1, 64, 8, 16)).astype(np.float32)
    mean, cov = tsp.feature_stats_psum(_shards(x, 4))
    g_mean, g_cov = feature_stats(torch.from_numpy(x))
    np.testing.assert_allclose(mean.numpy(), g_mean.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cov.numpy(), g_cov.numpy(), rtol=1e-4, atol=1e-4)
    j_mean, j_cov = shard_map(lambda xs: jsp.feature_stats_psum(xs, "space", 64 * 8),
                              mesh=jax_mesh, in_specs=SPEC, out_specs=(P(), P()))(jnp.asarray(x))
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cov.numpy(), np.asarray(j_cov), rtol=1e-4, atol=1e-4)
    f_mean, f_cov = jax_feature_stats(jnp.asarray(x))
    np.testing.assert_allclose(cov.numpy(), np.asarray(f_cov), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stages", [(1,), (3, 2, 1), (5, 4, 3, 2, 1)], ids=str)
def test_tiled_cascade_close_to_untiled(rng, jax_mesh, stages):
    """Full per-conv cascade against the port's plain cascade and the
    reference's sharded one. The bound is the reference's
    (tests/test_spatial.py:106-113): eigh on the toy pyramid's
    near-degenerate covariances amplifies float32 reordering for a handful
    of pixels, so at most 0.5 % of them may pass 5e-2 and none 1.5e-1."""
    jp = _toy_pyramid(stages, 0)
    tp = pyramid_from_jax(_np_tree(jp))
    content = rng.random((1, 64, 48, 3), dtype=np.float32)
    style = rng.random((1, 64, 48, 3), dtype=np.float32)
    fn = tsp.build_tiled_stylize_fn(tp, _cpu_mesh(4), stages=stages)
    # the reference's sharded function sums the style's statistics over its
    # shards: the same sums here, so that one cascade is held to the other
    style_stats = _sharded_style_stats(tp, _shards(style, 4), stages)
    tiled = _join(fn(_shards(content, 4), style_stats, 0.8))
    untiled = WCTEngine(pyramid=tp, stages=stages, device="cpu").stylize_device(
        torch.from_numpy(content), torch.from_numpy(style), 0.8)
    jparams = {s: {"enc": jp[s]["enc"], "dec": jp[s]["dec"]} for s in stages}
    want = jsp.build_tiled_stylize_fn(jp, jax_mesh, stages=stages)(
        jparams, jnp.asarray(content), jnp.asarray(style), 0.8)
    # stylize_device clips to [0, 1]; the cascades do not
    for other in (np.clip(tiled, 0, 1) - untiled.numpy(), tiled - np.asarray(want)):
        diff = np.abs(other)
        assert (diff > 5e-2).mean() <= 5e-3, (diff.max(), (diff > 5e-2).mean())
        assert diff.max() <= 1.5e-1, diff.max()
    if max(stages) > 1:   # 10 rows a shard do not divide the deepest pool
        with pytest.raises(ValueError, match="downsample factor"):
            fn(_shards(content[:, :40], 4), style_stats, 0.8)


def test_engine_per_conv_route_and_its_ultra_resolution_refusal(monkeypatch, rng):
    jp = _toy_pyramid((1,), 0)
    tp = pyramid_from_jax(_np_tree(jp))
    eng = WCTEngine(pyramid=tp, stages=(1,), device="cpu", space=4, devices=["cpu"] * 4)
    assert eng._tiled_fn is not None and eng._tiled_slab == 0
    with pytest.raises(ValueError, match="blending"):
        eng.blend_styles([np.zeros((16, 16, 3), np.float32)])
    small = rng.random((50, 40, 3), dtype=np.float32)   # rows pad to 64: 4 blocks of 16
    out = eng.stylize(small, small[:30])
    assert out.shape == small.shape and np.isfinite(out).all()
    # the style pads to 32 rows as on the plain path (the reference's sharded
    # engine pads it to 64 with mirrored rows that enter its statistics), so
    # the port is held to the reference's plain engine
    want = JaxEngine(mode="16x", pyramid=jp, stages=(1,)).stylize(small, small[:30])
    np.testing.assert_allclose(out, want, atol=ATOL, rtol=0)
    monkeypatch.setattr(tengine, "TILED_MAX_SHARD_PIX", 1024)
    big = np.zeros((256, 64, 3), np.float32)   # 4096 px per shard > the patched cap
    with pytest.raises(ValueError, match="slab_rows"):
        eng.stylize(big, big)
    assert tengine.TILED_MAX_SHARD_PIX == 1024 and eng.stylize(small, small).shape == small.shape


# ---- the per-conv path's cut: whole 16-row blocks, no pad row past the plain
#      path's, the style's statistics taken whole (deliberately unlike the
#      reference, whose rows pad to 16 * space with mirrored rows that enter
#      its statistics: 29-33 dB from its own plain engine at these shapes) ----

@pytest.fixture(scope="module")
def photo_engines(weights_root):
    import os
    from collaborative_distillation_tpu_torch.wct import slab as tslab
    with np.load(os.path.join(os.path.dirname(tslab.__file__), os.pardir, "data",
                              "photo_pair_512.npz")) as d:
        c, s = d["content"], d["style"]
    c = np.concatenate([c, c[::-1]])[:, :256].astype(np.float32) / 255.0
    s = np.concatenate([s, s[::-1]])[:, :256].astype(np.float32) / 255.0
    plain = WCTEngine(mode="16x", weights_root=weights_root, device="cpu")
    sharded = WCTEngine(pyramid=plain.pyramid, device="cpu", space=4, devices=["cpu"] * 4)
    return c, s, plain, sharded


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2))


@pytest.mark.parametrize("ch,sh", [(528, 256), (784, 256), (512, 272), (512, 400)],
                         ids=lambda v: str(v))
def test_per_conv_engine_matches_plain_at_heights_off_16_x_space(photo_engines, ch, sh):
    """Rows past a multiple of 64 (content or style): the plain engine's
    padding and statistics, so the shards' result is the plain one up to
    float32 order (>= 40 dB; 96-107 dB measured)."""
    c, s, plain, sharded = photo_engines
    got = sharded.stylize(c[:ch], s[:sh])
    assert got.shape == (ch, 256, 3)
    assert _psnr(got, plain.stylize(c[:ch], s[:sh])) >= 40.0


def _whole_and_sharded_style(sharded, plain, c, s, rows):
    """The per-conv engine's output at ``rows`` content rows with the
    style's statistics taken whole (as it runs) and summed over four style
    shards (as it ran before the cut by 16-row blocks), and the plain
    engine's, all unclipped."""
    assert sharded._block_rows(rows) == [rows // 4] * 4
    with torch.inference_mode():
        img, sty = sharded._prep(c[:rows]), sharded._prep(s[:256])
        got = sharded._run(img, sty, 1.0, num_run=1, style_key=None)
        fn = sharded._tiled_fn
        whole = {k: sharded._style_stats(k, sty) for k in sharded.stages}
        np.testing.assert_array_equal(got.numpy(), _join(fn(_shards(img, 4), whole, 1.0)))
        earlier = _join(fn(_shards(img, 4),
                           _sharded_style_stats(plain.pyramid, _shards(sty, 4), sharded.stages),
                           1.0))
        ref = plain._run(img, sty, 1.0, num_run=1, style_key=None)
    return [np.clip(np.asarray(x), 0, 1) for x in (got, earlier, ref)]


@pytest.mark.parametrize("rows", [512, 256])
def test_per_conv_engine_unchanged_at_multiples_of_16_x_space(photo_engines, rows):
    """At 512 and 256 rows the content is cut as before (four equal shards;
    at 256, four rows each at stage 5) and the cascade is the same; only the
    style's statistics are now summed whole rather than over its four
    shards, which moves the output by float32 order alone: the two forms
    sit 80 dB or more from each other (94 and 93 dB read) and from the plain
    engine (93-97 and 89-90 dB read)."""
    c, s, plain, sharded = photo_engines
    got, earlier, ref = _whole_and_sharded_style(sharded, plain, c, s, rows)
    assert _psnr(got, earlier) >= 80.0
    assert min(_psnr(got, ref), _psnr(earlier, ref)) >= 80.0


def test_whole_and_sharded_style_statistics_are_float32_roundings(photo_engines):
    """The witness for the cause of the move above: both forms of the
    style's covariance, whole (the engine's) and summed over four shards
    (the earlier one), lie within 1e-5 of the largest entry of the float64
    covariance at every stage (1.2e-6 read), so neither is the truer and
    they differ by float32 order alone."""
    _, s, plain, sharded = photo_engines
    with torch.inference_mode():
        sty = sharded._prep(s[:256])
        earlier = _sharded_style_stats(plain.pyramid, _shards(sty, 4), sharded.stages)
        for k in sharded.stages:
            p = plain.pyramid[k]
            x = apply_encoder(p["enc"], sty, p["enc_spec"], aux=False)["out"]
            x = x.reshape(-1, x.shape[-1]).double()
            m64 = x.mean(0)
            cov64 = (x - m64).T @ (x - m64) / (x.shape[0] - 1)
            scale = float(cov64.abs().max())
            for mean, cov in (sharded._style_stats(k, sty), earlier[k]):
                assert float((cov.double() - cov64).abs().max()) <= 1e-5 * scale, k
                assert float((mean.double() - m64).abs().max()) <= 1e-5 * float(m64.abs().max()), k


def test_per_conv_engine_deals_blocks_and_refuses_too_short_images(photo_engines):
    c, s, _, sharded = photo_engines
    assert sharded._block_rows(528) == [128, 128, 128, 144]
    assert sharded._block_rows(784) == [192, 192, 192, 208]
    assert sharded._block_rows(80) == [16, 16, 16, 32]
    with pytest.raises(ValueError, match="at least 49 rows"):
        sharded.stylize(c[:48, :64], s[:64, :64])
    assert sharded.stylize(c[:49, :64], s[:40, :64]).shape == (49, 64, 3)
