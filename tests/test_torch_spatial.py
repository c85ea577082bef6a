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
    the other neighbour's, as the reference's ``halo_exchange_rows`` picks it."""
    x = rng.random((1, 4, 6, 5), np.float32)
    ext = tsp.halo_exchange_rows(_shards(x, 4))
    want_top, want_bot = shard_map(lambda xs: jsp.halo_exchange_rows(xs, "space"),
                                   mesh=jax_make_mesh(space=4), in_specs=SPEC,
                                   out_specs=(SPEC, SPEC))(jnp.asarray(x))
    np.testing.assert_array_equal(np.concatenate([e[:, :1] for e in ext], 1), want_top)
    np.testing.assert_array_equal(np.concatenate([e[:, -1:] for e in ext], 1), want_bot)
    two = tsp.halo_exchange_rows(_shards(rng.random((1, 8, 6, 5), np.float32), 4))
    assert all(e.shape == (1, 4, 6, 5) for e in two)
    assert torch.equal(two[0][:, 0], two[0][:, 2]) and torch.equal(two[3][:, 3], two[3][:, 1])


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
    tiled = _join(fn(_shards(content, 4), _shards(style, 4), 0.8))
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
            fn(_shards(content[:, :40], 4), _shards(style, 4), 0.8)


def test_engine_per_conv_route_and_its_ultra_resolution_refusal(monkeypatch, rng):
    jp = _toy_pyramid((1,), 0)
    tp = pyramid_from_jax(_np_tree(jp))
    eng = WCTEngine(pyramid=tp, stages=(1,), device="cpu", space=4, devices=["cpu"] * 4)
    assert eng._tiled_fn is not None and eng._tiled_slab == 0
    with pytest.raises(ValueError, match="blending"):
        eng.blend_styles([np.zeros((16, 16, 3), np.float32)])
    small = rng.random((50, 40, 3), dtype=np.float32)   # rows pad to 64 = 16 * space
    out = eng.stylize(small, small[:30])
    assert out.shape == small.shape and np.isfinite(out).all()
    want = JaxEngine(mode="16x", pyramid=jp, stages=(1,), space=4).stylize(small, small[:30])
    np.testing.assert_allclose(out, want, atol=ATOL, rtol=0)
    monkeypatch.setattr(tengine, "TILED_MAX_SHARD_PIX", 1024)
    big = np.zeros((256, 64, 3), np.float32)   # 4096 px per shard > the patched cap
    with pytest.raises(ValueError, match="slab_rows"):
        eng.stylize(big, big)
    assert tengine.TILED_MAX_SHARD_PIX == 1024 and eng.stylize(small, small).shape == small.shape
