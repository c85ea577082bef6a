"""The port's ``packed``: each encoder's ``conv0`` folded into ``conv1_1``
(``models/packed_vgg.py``) on the slab paths, against the reference's
``packed=True`` on the CPU.

The fold against the reference's ``pack_stage_params``: the port's folded
``conv1_1`` goes through the reference's ``pack_conv3x3_weights`` at the
packing plan's ``f_in`` and is held to the reference's packed weights,
float32 within 1e-6 of max|w|, bf16 within one bf16 ulp (both compose in
float32 with numpy and round once). The folded paths against the
reference's packed ones on the photo pair's real content: float32 at PSNR
>= 40 dB (the parity bar of tests/test_torch_slab.py), bf16 within 2e-2 of
max|ref| (the reference's own bar between its packed and unpacked
cascades, tests/test_tiled_slab.py). No ``conv0`` product runs on a folded
path, and a tree without ``conv0`` that was never folded raises.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from collaborative_distillation_tpu.models.packed_vgg import (apply_encoder_packed as
                                                              jax_apply_encoder_packed)
from collaborative_distillation_tpu.models.packed_vgg import pack_stage_params as jax_pack
from collaborative_distillation_tpu.models.packed_vgg import plan_packing
from collaborative_distillation_tpu.models.specs import encoder_spec as jax_encoder_spec
from collaborative_distillation_tpu.models.zoo import load_pyramid as jax_load_pyramid
from collaborative_distillation_tpu.ops.packed import pack_conv3x3_weights, unpack_width
from collaborative_distillation_tpu.parallel import spatial as jsp
from collaborative_distillation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from collaborative_distillation_tpu.wct import slab as jslab
from collaborative_distillation_tpu.wct.engine import WCTEngine as JaxEngine

import torch

from collaborative_distillation_tpu_torch.models import packed_vgg as tpv
from collaborative_distillation_tpu_torch.models import vgg as tvgg
from collaborative_distillation_tpu_torch.models.specs import encoder_spec
from collaborative_distillation_tpu_torch.models.zoo import PREPROC_CONV0
from collaborative_distillation_tpu_torch.parallel import spatial as tsp
from collaborative_distillation_tpu_torch.parallel.mesh import make_mesh
from collaborative_distillation_tpu_torch.utils.params import params_from_jax, pyramid_from_jax
from collaborative_distillation_tpu_torch.wct import slab as tslab
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

BF16 = torch.bfloat16
PAIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "collaborative_distillation_tpu_torch", "data", "photo_pair_512.npz")
PSNR_MIN_DB = 40.0
BF16_TOL = 2e-2
STAGES = (2, 1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr(a, b) -> float:
    return float(10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cast(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


@pytest.fixture(scope="module")
def jax_16x(weights_root):
    return jax_load_pyramid("16x", weights_root)


@pytest.fixture(scope="module")
def pair():
    with np.load(PAIR) as d:
        return d["content"].astype(np.float32) / 255.0, d["style"].astype(np.float32) / 255.0


def _teacher_encoder(stage: int):
    """A seeded teacher-width (``original``) encoder with the reference's
    preprocessing ``conv0``: numpy leaves, HWIO."""
    spec = jax_encoder_spec("original", stage)
    rng = np.random.default_rng(100 + stage)
    tree = {}
    for name, (wshape, bshape) in spec.param_shapes().items():
        if name == "conv0":
            tree[name] = {k: v.copy() for k, v in PREPROC_CONV0.items()}
        else:
            fan_in = wshape[0] * wshape[1] * wshape[2]
            tree[name] = {"w": (rng.standard_normal(wshape) / np.sqrt(fan_in)).astype(np.float32),
                          "b": (0.1 * rng.standard_normal(bshape)).astype(np.float32)}
    return spec, tree


# ---- the fold against the reference's pack_stage_params ---------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["16x", "original"])
@pytest.mark.parametrize("stage", [1, 2, 3, 4, 5])
def test_fold_matches_reference_pack_stage_params(jax_16x, family, stage, dtype):
    if family == "16x":
        jspec, jtree = jax_16x[stage]["enc_spec"], _np_tree(jax_16x[stage]["enc"])
    else:
        jspec, jtree = _teacher_encoder(stage)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jtree = _np_tree(_cast(jtree, jdt))           # the engine casts, then folds
    want = jax_pack(jtree, jspec)
    params = params_from_jax(jtree)
    spec = encoder_spec(family, stage, aux=family == "16x")
    got = tpv.pack_stage_params(params, spec)
    assert isinstance(got, tpv.FoldedParams) and "conv0" not in got
    assert set(got) == set(params) - {"conv0"}
    first = spec.layers[0].name
    assert got[first]["w"].dtype == got[first]["b"].dtype == params[first]["w"].dtype
    for layer in spec.layers[1:]:   # every other layer untouched
        assert got[layer.name] is params[layer.name]
    f_in = plan_packing(jspec)[0][1]
    mine = [np.asarray(t.float().numpy()).astype(jdt) for t in got[first].values()]
    for g, w in zip(pack_conv3x3_weights(*mine, f_in), (want[first]["w"], want[first]["b"])):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        if dtype == "float32":
            assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
        else:
            assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w)).all()
    # the fold is the encoder's conv0 followed by its conv1_1, borders included
    x = torch.from_numpy(np.random.default_rng(stage).random((1, 9, 7, 3), np.float32))
    x = x.to(params[first]["w"].dtype)
    p = params[first]
    ref = tvgg.conv3x3(tvgg.conv1x1(x, params["conv0"]["w"], params["conv0"]["b"]),
                       p["w"], p["b"], relu=False).float()
    out = tvgg.conv3x3(x, got[first]["w"], got[first]["b"], relu=False).float()
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


def test_fold_leaves_decoders_and_folded_trees_alone(jax_16x):
    tp = pyramid_from_jax({k: {**v, "enc": _np_tree(v["enc"]), "dec": _np_tree(v["dec"])}
                           for k, v in jax_16x.items()})
    for k in (5, 1):
        dec = tp[k]["dec"]
        assert tpv.pack_stage_params(dec, tp[k]["dec_spec"]) is dec
        folded = tpv.pack_stage_params(tp[k]["enc"], tp[k]["enc_spec"])
        assert tpv.pack_stage_params(folded, tp[k]["enc_spec"]) is folded


def test_unfolded_tree_without_conv0_raises(jax_16x):
    """The loader fills a missing conv0 in, so an encoder tree without one
    that was never folded is a fault: every encoder refuses it."""
    tp = pyramid_from_jax({1: {**jax_16x[1], "enc": _np_tree(jax_16x[1]["enc"]),
                               "dec": _np_tree(jax_16x[1]["dec"])}})
    enc, spec = tp[1]["enc"], tp[1]["enc_spec"]
    bare = {name: leaf for name, leaf in enc.items() if name != "conv0"}
    x = torch.rand((1, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    with pytest.raises(KeyError, match="not folded"):
        tvgg.apply_encoder(bare, x, spec)
    with pytest.raises(KeyError, match="not folded"):
        tsp.apply_encoder_spatial([bare, bare], [x[:, :8], x[:, 8:]], spec)
    with pytest.raises(KeyError, match="not folded"):
        tslab.SlabCascade({1: {**tp[1], "enc": bare}}, stages=(1,), slab_rows=8).style_stats(1, x)
    with pytest.raises(TypeError, match="folded"):
        tpv.apply_encoder_packed(enc, x, spec)
    with pytest.raises(TypeError, match="folded"):
        tsp.apply_encoder_spatial_packed([enc, enc], [x[:, :8], x[:, 8:]], spec)
    folded = tpv.pack_stage_params(enc, spec)
    got = tpv.apply_encoder_packed(folded, x, spec)["out"]
    want = tvgg.apply_encoder(enc, x, spec)["out"]
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage", [1, 5])
def test_folded_encoder_matches_reference_packed_encoder(jax_16x, pair, stage, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jspec = jax_16x[stage]["enc_spec"]
    jtree = _cast(jax_16x[stage]["enc"], jdt)
    x = pair[0][None, :64, :64]
    feats, f = jax_apply_encoder_packed(jax_pack(jtree, jspec), jnp.asarray(x, jdt), jspec)
    want = np.asarray(unpack_width(feats, f), np.float32)
    tp = params_from_jax(_np_tree(jtree))
    got = tpv.apply_encoder_packed(tpv.pack_stage_params(tp, encoder_spec("16x", stage, aux=True)),
                                   torch.from_numpy(x).to(tp["conv11"]["w"].dtype),
                                   encoder_spec("16x", stage, aux=True), aux=False)["out"]
    tol = 1e-4 if dtype == "float32" else BF16_TOL
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


# ---- the folded paths against the reference's packed ones ----------------------

@pytest.fixture(scope="module")
def pyramids(jax_16x):
    jp = {k: jax_16x[k] for k in STAGES}
    tp = pyramid_from_jax({k: {**v, "enc": _np_tree(v["enc"]), "dec": _np_tree(v["dec"])}
                           for k, v in jp.items()})
    return jp, tp


def _bf16_pyramids(jp):
    jp16 = {k: {**v, "enc": _cast(v["enc"], jnp.bfloat16), "dec": _cast(v["dec"], jnp.bfloat16)}
            for k, v in jp.items()}
    tp16 = pyramid_from_jax({k: {**v, "enc": _np_tree(v["enc"]), "dec": _np_tree(v["dec"])}
                             for k, v in jp16.items()})
    return jp16, tp16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["per_stage", "fused"])
def test_slab_cascades_packed_match_reference(pyramids, pair, path, dtype):
    jp, tp = pyramids
    if dtype == "bfloat16":
        jp, tp = _bf16_pyramids(jp)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    c, s = pair[0][None, 100:228, 200:264], pair[1][None, :64, :64]
    jc, js = jnp.asarray(c, jdt), jnp.asarray(s, jdt)
    if path == "per_stage":
        want = jslab.SlabCascade(jp, stages=STAGES, slab_rows=32, packed=True).stylize(jc, js, 0.9)
    else:
        jfn, jparams = jslab.build_fused_slab_cascade(jp, stages=STAGES, slab_rows=32,
                                                      packed=True)
        want = jfn(jparams, jc, js, 0.9)
    want = np.asarray(want, np.float32)
    tc, ts = (torch.from_numpy(a).to(BF16 if dtype == "bfloat16" else torch.float32)
              for a in (c, s))
    if path == "per_stage":
        cas = tslab.SlabCascade(tp, stages=STAGES, slab_rows=32, packed=True)
        assert all(isinstance(cas.params[k]["enc"], tpv.FoldedParams) for k in STAGES)
        got = cas.stylize(tc, ts, 0.9)
    else:
        got = tslab.build_fused_slab_cascade(tp, stages=STAGES, slab_rows=32, packed=True)(
            tc, ts, 0.9)
    got = got.float().numpy()
    assert got.shape == want.shape == c.shape
    if dtype == "float32":
        assert _psnr(got, want) >= PSNR_MIN_DB
    else:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_slab_in_shard_packed_matches_reference(pyramids, pair, dtype):
    """The engine's default slab-in-shard route folds, as the reference's
    engine does: both on 4 row shards (the reference's virtual CPU mesh,
    the port's ``devices=["cpu"] * 4``), a height of 4 whole slabs."""
    jp, tp = pyramids
    kw = {}
    if dtype == "bfloat16":
        jp, tp = _bf16_pyramids(jp)
        kw = dict(dtype=jnp.bfloat16)
    c, s = pair[0][:128, 300:364], pair[1][:64, :64]
    want = np.asarray(JaxEngine(mode="16x", pyramid=jp, stages=STAGES, space=4, slab_rows=32,
                                packed=True, **kw).stylize(c, s, alpha=0.9), np.float32)
    eng = WCTEngine(pyramid=tp, stages=STAGES, device="cpu", space=4, slab_rows=32,
                    devices=["cpu"] * 4, dtype=BF16 if dtype == "bfloat16" else torch.float32)
    assert eng.packed and eng._tiled_slab == 32
    got = eng.stylize(c, s, alpha=0.9)
    assert got.shape == want.shape == c.shape
    if dtype == "float32":
        assert _psnr(got, want) >= PSNR_MIN_DB
    else:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()


def test_tiled_stylize_fn_packed_matches_reference(pyramids, pair):
    jp, tp = pyramids
    c, s = pair[0][None, 200:328, 64:128], pair[1][None, 64:192, :64]
    jfn, jparams = jsp.build_tiled_stylize_fn_packed(jp, jax_make_mesh(space=4), stages=STAGES)
    want = np.asarray(jfn(jparams, jnp.asarray(c), jnp.asarray(s), 0.8))
    fn = tsp.build_tiled_stylize_fn_packed(tp, make_mesh(space=4, devices=["cpu"] * 4),
                                           stages=STAGES)
    shards = fn(list(torch.from_numpy(c).split(32, dim=1)),
                list(torch.from_numpy(s).split(32, dim=1)), 0.8)
    got = torch.cat(shards, dim=1).numpy()
    assert got.shape == want.shape == c.shape
    assert _psnr(got, want) >= PSNR_MIN_DB


# ---- no conv0 product on a folded path --------------------------------------------

@pytest.fixture()
def conv0_calls(monkeypatch):
    """Counts ``conv1x1`` calls with conv0's (1, 1, 3, 3) weights, wherever
    an encoder reaches it."""
    calls = []
    real = tvgg.conv1x1

    def counted(x, w, b=None, **kw):
        if tuple(w.shape) == (1, 1, 3, 3):
            calls.append(tuple(x.shape))
        return real(x, w, b, **kw)

    monkeypatch.setattr(tvgg, "conv1x1", counted)
    monkeypatch.setattr(tsp, "conv1x1", counted)
    return calls


def test_folded_paths_run_no_conv0(pyramids, pair, conv0_calls):
    _, tp = pyramids
    c, s = pair[0][:128, :64], pair[1][:64, :64]
    slab_kw = dict(pyramid=tp, stages=STAGES, device="cpu", slab_rows=32)
    shard_kw = dict(slab_kw, space=4, devices=["cpu"] * 4)
    for kw in (slab_kw, dict(slab_kw, fused=False), dict(slab_kw, stream_min_pix=1)):
        eng = WCTEngine(**kw)
        assert eng.slab.packed and c.shape[0] >= 2 * eng.slab.margin   # no plain bypass
        eng.stylize(c, s)
        eng.stylize((c * 255).astype(np.uint8), s, as_uint8=True)   # the streamed tail
    assert conv0_calls == []
    # a blend takes the fused path's statistics from its folded encoders and
    # the per-stage entries from the unfolded ones, as in JAX (engine.py:410-426)
    key, proxy = eng.blend_styles([s, s[::-1].copy()])
    assert len(conv0_calls) == 2 * len(STAGES)
    del conv0_calls[:]
    eng.stylize(c, proxy, style_key=key)
    assert conv0_calls == []
    eng = WCTEngine(**shard_kw)
    eng.stylize(c, s, style_key="k")
    assert len(conv0_calls) == len(STAGES)   # the style's statistics, unfolded as in JAX
    del conv0_calls[:]
    eng.stylize(c, s, style_key="k")          # cached: no conv0 at all
    fn = tsp.build_tiled_stylize_fn_packed(tp, make_mesh(space=4, devices=["cpu"] * 4),
                                           stages=STAGES)
    fn(list(torch.from_numpy(c[None]).split(32, dim=1)),
       list(torch.from_numpy(s[None]).split(16, dim=1)), 1.0)
    assert conv0_calls == []
    # packed=False, the plain path and the per-conv sharded path keep conv0
    eng = WCTEngine(**slab_kw, packed=False)
    eng.stylize(c, s)   # the style, and each window once (pass 2 reads pass 1's features)
    assert len(conv0_calls) == sum(1 + len(list(eng.slab._slabs(128, k))) for k in STAGES)
    del conv0_calls[:]
    WCTEngine(pyramid=tp, stages=STAGES, device="cpu", packed=True).stylize(c, s)
    assert len(conv0_calls) == 2 * len(STAGES)
    del conv0_calls[:]
    WCTEngine(pyramid=tp, stages=STAGES, device="cpu", space=4,
              devices=["cpu"] * 4).stylize(c, s)
    assert len(conv0_calls) == 5 * len(STAGES)   # the style whole, the content's 4 shards
