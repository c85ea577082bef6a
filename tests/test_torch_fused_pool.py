"""The conv with its 2x2 max pool or its nearest 2x upsample folded into one
launch (``ops/cuda/fused.py``; ``ops.conv.conv3x3_pool`` and
``conv3x3_upsampled``) and the model route that takes them, on the CPU.

* The plain versions are the compositions of the separate plain ops bit for
  bit, and agree with the reference's XLA conv followed by its Pallas pool
  (interpret mode), or its Pallas upsample followed by the conv, to float32
  rounding of the conv (exactly in the pool and upsample).
* With the CPU in ``ops.conv.FUSE_DEVICES`` the model functions take the
  fused route on CPU maps (the plain versions), as they take it on the card:
  encoders and decoders match the reference package's at the model tests'
  tolerance, and the separate route's output bit for bit, at odd sizes,
  2x2 and 1-pixel maps and N = 2.
* The route rules: autograd recording, ``with_pool_argmax``, requested
  decoder taps, the per-conv path's halo rows, widths without a fused
  instantiation and devices outside ``FUSE_DEVICES`` keep the separate ops.
* The plans: a fused instantiation for every fused shape of the 2048^2, UHD
  slab and sharded UHD cascades (chip_smoke.py's plans), the same launch as
  the conv's own; a refusal where none exists; the tables are the CUDA
  sources' instantiations.
* The wrappers' ctypes path through a stub library (the plain versions on
  the host memory behind the pointers): the conv's map, the template and the
  fuse id reach the C entry, and the launches count.

On the card: ``tests/test_torch_gpu.py -k fused`` and chip_smoke.py.
"""

import contextlib
import ctypes
import os
import re
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from collaborative_distillation_tpu.models import decoder_spec, encoder_spec, init_params
from collaborative_distillation_tpu.models import vgg as jvgg
from collaborative_distillation_tpu.ops import conv as jconv
from collaborative_distillation_tpu.ops.pallas.pool import packed_pool_lane, packed_upsample_lane

import torch

import chip_smoke
from collaborative_distillation_tpu_torch.models import vgg as tvgg
from collaborative_distillation_tpu_torch.models.zoo import stage_specs
from collaborative_distillation_tpu_torch.ops import conv as tconv
from collaborative_distillation_tpu_torch.ops import cuda as kc
from collaborative_distillation_tpu_torch.ops.cuda import _build
from collaborative_distillation_tpu_torch.ops.cuda import conv as kconv
from collaborative_distillation_tpu_torch.ops.cuda import fused as kfused
from collaborative_distillation_tpu_torch.ops.cuda import pool as kpool
from collaborative_distillation_tpu_torch.parallel import spatial as tsp
from collaborative_distillation_tpu_torch.utils.params import pyramid_from_jax
from collaborative_distillation_tpu_torch.wct.slab import FEATURE_CACHE_BYTES, SlabCascade

BF16 = torch.bfloat16
N_SM = 132   # an H100 SXM's SMs
STAGES = (5, 4, 3, 2, 1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process (several run at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conv_inputs(rng, n, h, w, ci, co, dtype=torch.float32):
    x = torch.from_numpy(rng.random((n, h, w, ci), np.float32))
    wt = torch.from_numpy(((rng.random((3, 3, ci, co)) - 0.5) * (2 / (9 * ci) ** 0.5))
                          .astype(np.float32))
    b = torch.from_numpy((rng.random(co) - 0.5).astype(np.float32))
    return x.to(dtype), wt.to(dtype), b.to(dtype)


def _bits(t):
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32)


# (N, H, W, Cin, Cout): for the pool the conv's map (odd sizes drop a row or
# a column, 1 x 1 pools to nothing), for the upsample its half-resolution
# input (a 1-pixel map reflects onto itself after the doubling)
POOL_CASES = [(1, 7, 9, 16, 16), (2, 8, 6, 32, 32), (1, 2, 3, 64, 64), (1, 3, 3, 128, 128),
              (1, 1, 1, 16, 16), (1, 2, 2, 24, 3)]
UP_CASES = [(1, 1, 1, 16, 16), (2, 3, 5, 32, 32), (1, 4, 4, 64, 64), (1, 5, 2, 128, 128),
            (1, 3, 4, 3, 24)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", POOL_CASES, ids=str)
def test_conv3x3_pool_plain_is_the_composition(rng, dtype, case):
    x, wt, b = _conv_inputs(rng, *case, dtype)
    for relu in (True, False):
        got = kfused.conv3x3_pool_plain(x, wt, b, relu)
        want = kpool.max_pool_2x2_plain(kconv.conv3x3_plain(x, wt, b, relu))
        assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))
        # the op on a CPU map is the plain version
        assert torch.equal(_bits(tconv.conv3x3_pool(x, wt, b, relu=relu)), _bits(got))


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", UP_CASES, ids=str)
def test_conv3x3_up_plain_is_the_composition(rng, dtype, case):
    x, wt, b = _conv_inputs(rng, *case, dtype)
    for relu in (True, False):
        got = kfused.conv3x3_up_plain(x, wt, b, relu)
        want = kconv.conv3x3_plain(kpool.upsample_nearest_2x_plain(x), wt, b, relu)
        assert got.shape == (case[0], 2 * case[1], 2 * case[2], case[4])
        assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))
        assert torch.equal(_bits(tconv.conv3x3_upsampled(x, wt, b, relu=relu)), _bits(got))


@pytest.mark.parametrize("case", [(1, 8, 12, 16, 16), (1, 6, 10, 128, 128), (1, 4, 6, 32, 32)],
                         ids=str)
def test_fused_plain_matches_reference_xla_conv_and_pallas(rng, case):
    """The reference's XLA conv, then its Pallas pool (f == 1, interpret
    mode); its Pallas upsample, then the conv: the pool and upsample exact,
    the conv within float32 rounding (1e-5 of the output's magnitude)."""
    n, h, w, ci, co = case
    x, wt, b = _conv_inputs(rng, n, h, w, ci, co)
    jx, jw, jb = (jnp.asarray(t.numpy()) for t in (x, wt, b))
    conv = np.asarray(jconv.conv3x3(jx, jw, jb, relu=True))
    # the pool of the port's conv is the Pallas pool of it, exactly
    tc = kconv.conv3x3_plain(x, wt, b, True)
    pallas = np.asarray(packed_pool_lane(jnp.asarray(tc[0].numpy()), f=1, c=co,
                                         block_h=h // 2, block_w=w, interpret=True))
    got = kfused.conv3x3_pool_plain(x, wt, b, True)
    np.testing.assert_array_equal(got[0].numpy(), pallas)
    want = np.asarray(jconv.max_pool_2x2(jnp.asarray(conv)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the upsample: the Pallas upsample of x ((2H, W, 2C) at f == 1: each
    # pixel's two copies side by side), then the conv
    up = np.asarray(packed_upsample_lane(jx[0], f=1, c=ci, block_h=h, block_w=w,
                                         interpret=True)).reshape(1, 2 * h, 2 * w, ci)
    np.testing.assert_array_equal(up, kpool.upsample_nearest_2x_plain(x).numpy())
    want = np.asarray(jconv.conv3x3(jnp.asarray(up), jw, jb, relu=True))
    got = kfused.conv3x3_up_plain(x, wt, b, True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ---- the route ---------------------------------------------------------------------

@pytest.fixture()
def route(monkeypatch):
    """The fused route on CPU maps (the CPU in ``FUSE_DEVICES``), and the
    calls of each op the model functions make, counted."""
    monkeypatch.setattr(tconv, "FUSE_DEVICES", frozenset({"cuda", "cpu"}))
    calls = {}
    for name in ("conv3x3", "conv3x3_pool", "conv3x3_upsampled", "max_pool_2x2",
                 "upsample_nearest_2x", "max_pool_2x2_with_argmax"):
        fn = getattr(tvgg, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tvgg, name, counted)
    return calls


def _toy_stage(stage, key=0, family="16x"):
    k1, k2 = jax.random.split(jax.random.key(key + stage))
    es, ds = encoder_spec(family, stage), decoder_spec(family, stage)
    jp = {"enc_spec": es, "dec_spec": ds,
          "enc": jax.tree.map(np.asarray, init_params(es, k1)),
          "dec": jax.tree.map(np.asarray, init_params(ds, k2))}
    return jp, pyramid_from_jax({stage: jp})[stage]


def _close(got, want, rel=1e-5):
    w = np.asarray(want)
    assert got.shape == w.shape
    np.testing.assert_allclose(got.numpy(), w, rtol=rel, atol=rel * max(np.abs(w).max(), 1e-3))


@pytest.mark.parametrize("stage,shape", [(2, (1, 32, 48)), (3, (1, 37, 45)), (4, (2, 18, 22)),
                                         (5, (1, 16, 16)), (5, (1, 35, 19)), (3, (1, 4, 4))],
                         ids=str)
def test_fused_route_matches_reference_and_separate_route(rng, route, monkeypatch, stage, shape):
    """Encoder and decoder (no taps) on the fused route against the
    reference package's, and bit for bit against the separate route. At 16 x
    16 the stage-5 encoder pools a 2x2 map to one pixel and convolves it; at
    4 x 4 stage 3 ends at 1 x 1; odd sizes drop rows and columns."""
    jp, tp = _toy_stage(stage)
    x = rng.random((*shape, 3)).astype(np.float32)
    enc = tvgg.apply_encoder(tp["enc"], torch.from_numpy(x), tp["enc_spec"], aux=False)
    jenc = jvgg.apply_encoder(jp["enc"], jnp.asarray(x), jp["enc_spec"])
    _close(enc["out"], jenc["out"])
    for tap in [k for k in enc if k.startswith("relu")]:
        _close(enc[tap], jenc[tap])
    feat = np.asarray(jenc["out"])
    dec = tvgg.apply_decoder(tp["dec"], torch.from_numpy(feat), tp["dec_spec"], taps=False)
    assert set(dec) == {"out"}
    _close(dec["out"], jvgg.apply_decoder(jp["dec"], jnp.asarray(feat), jp["dec_spec"])["out"])
    pools = stage - 1
    assert route.get("conv3x3_pool", 0) == pools and route.get("conv3x3_upsampled", 0) == pools
    assert route.get("max_pool_2x2", 0) == 0 and route.get("upsample_nearest_2x", 0) == 0
    # the separate ops give the same bits
    monkeypatch.setattr(tconv, "FUSE_DEVICES", frozenset())
    sep = tvgg.apply_encoder(tp["enc"], torch.from_numpy(x), tp["enc_spec"], aux=False)
    sep_dec = tvgg.apply_decoder(tp["dec"], torch.from_numpy(feat), tp["dec_spec"], taps=False)
    assert torch.equal(sep["out"], enc["out"]) and torch.equal(sep_dec["out"], dec["out"])
    assert route["max_pool_2x2"] == pools and route["upsample_nearest_2x"] == pools


def test_fused_route_bf16_is_the_separate_route_bit_for_bit(rng, route, monkeypatch):
    _, tp = _toy_stage(4)
    enc = {n: {k: t.to(BF16) for k, t in p.items()} for n, p in tp["enc"].items()}
    dec = {n: {k: t.to(BF16) for k, t in p.items()} for n, p in tp["dec"].items()}
    x = torch.from_numpy(rng.random((2, 21, 30, 3), np.float32)).to(BF16)
    outs = []
    for devices in (frozenset({"cpu"}), frozenset()):
        monkeypatch.setattr(tconv, "FUSE_DEVICES", devices)
        f = tvgg.apply_encoder(enc, x, tp["enc_spec"], aux=False)["out"]
        outs.append((f, tvgg.apply_decoder(dec, f, tp["dec_spec"], taps=False)["out"]))
    assert route["conv3x3_pool"] == 3 and route["conv3x3_upsampled"] == 3
    assert route["max_pool_2x2"] == 3 and route["upsample_nearest_2x"] == 3
    for a, b in zip(*outs):
        assert a.dtype == BF16 and torch.equal(_bits(a), _bits(b))


def test_route_rules_keep_the_separate_ops(rng, route):
    """Recording autograd, the argmax pool, decoder taps asked for: the
    separate ops, and the outputs as they were."""
    _, tp = _toy_stage(3)
    x = torch.from_numpy(rng.random((1, 20, 24, 3), np.float32))
    spec = tp["enc_spec"]
    trainable = {n: {k: t.clone().requires_grad_() for k, t in p.items()}
                 for n, p in tp["enc"].items()}
    out = tvgg.apply_encoder(trainable, x, spec, aux=False)["out"]
    assert out.grad_fn is not None
    assert route.get("conv3x3_pool", 0) == 0 and route["max_pool_2x2"] == 2
    with torch.no_grad():   # the same params, nothing recording: fused
        tvgg.apply_encoder(trainable, x, spec, aux=False)
    assert route["conv3x3_pool"] == 2
    feats = tvgg.apply_encoder(tp["enc"], x, spec, aux=False, with_pool_argmax=True)
    assert route["max_pool_2x2_with_argmax"] == 2 and route["conv3x3_pool"] == 2
    assert {"pool1_idx", "pool2_idx"} <= set(feats)
    f = feats["out"]
    taps = tvgg.apply_decoder(tp["dec"], f, tp["dec_spec"])
    assert {"dec31", "dec21", "out"} <= set(taps)
    assert route.get("conv3x3_upsampled", 0) == 0 and route["upsample_nearest_2x"] == 2
    fused = tvgg.apply_decoder(tp["dec"], f, tp["dec_spec"], taps=False)
    assert route["conv3x3_upsampled"] == 2 and torch.equal(fused["out"], taps["out"])


def test_route_rules_devices_widths_and_halo_rows(rng, monkeypatch):
    x = torch.zeros(1, 4, 4, 16)
    w16 = torch.zeros(3, 3, 16, 16)
    # the default: the card only, so CPU maps keep the separate ops
    assert tconv.FUSE_DEVICES == frozenset({"cuda"}) and not tconv.fuses(x, w16)
    monkeypatch.setattr(tconv, "FUSE_DEVICES", frozenset({"cpu"}))
    assert tconv.fuses(x, w16) and tconv.fuses(x.to(BF16), w16.to(BF16))
    for ci, co, dtype in ((256, 256, torch.float32), (512, 512, BF16), (256, 256, BF16),
                          (3, 24, torch.float32), (24, 3, torch.float32), (129, 64, torch.float32),
                          (16, 16, torch.float16), (3, 16, BF16)):
        assert not tconv.fuses(torch.zeros(1, 2, 2, ci, dtype=dtype),
                               torch.zeros(3, 3, ci, co, dtype=dtype)), (ci, co, dtype)
    with pytest.raises(ValueError, match="inference only"):
        tconv.conv3x3_pool(x, w16.requires_grad_(), None)
    with pytest.raises(ValueError, match="inference only"):
        tconv.conv3x3_upsampled(x.requires_grad_(), torch.zeros(3, 3, 16, 16), None)
    # the per-conv sharded path's convs stage halo rows: never fused
    used = []
    for name in ("conv3x3_pool_plain", "conv3x3_up_plain"):
        fn = getattr(kfused, name)
        monkeypatch.setattr(kfused, name, lambda *a, _fn=fn, _n=name: used.append(_n) or _fn(*a))
    _, tp = _toy_stage(3)
    img = torch.from_numpy(rng.random((1, 64, 24, 3), np.float32))
    shards = list(torch.split(img, 16, dim=1))
    feats = tsp.apply_encoder_spatial([tp["enc"]] * 4, shards, tp["enc_spec"])["out"]
    tsp.apply_decoder_spatial([tp["dec"]] * 4, feats, tp["dec_spec"])
    assert used == []
    tvgg.apply_encoder(tp["enc"], img, tp["enc_spec"], aux=False)
    assert used == ["conv3x3_pool_plain"] * 2


# ---- the plans ---------------------------------------------------------------------

def _fused_path_shapes():
    """{(kind, (N, H, W, Cin, Cout))} of the fused convs of the 2048^2, UHD
    slab and sharded UHD cascades (chip_smoke.py's plans), H, W the conv's."""
    pyr = {k: dict(zip(("enc_spec", "dec_spec"), stage_specs("16x", k))) for k in STAGES}
    margins = SlabCascade(pyr, stages=STAGES, slab_rows=chip_smoke.UHD_SLAB).margins
    h, w = chip_smoke.UHD_H, chip_smoke.UHD_W
    plans = [chip_smoke.path_calls(pyr, STAGES, 2048, 2048)[0],
             chip_smoke.slab_path_calls(pyr, STAGES, margins, chip_smoke.UHD_SLAB, h, w, 2048,
                                        2048, FEATURE_CACHE_BYTES)[0],
             chip_smoke.sharded_path_calls(pyr, STAGES, margins, chip_smoke.SHARD_SLAB,
                                           chip_smoke.SHARDS, h, w, 2048, 2048)[0]]
    return sorted({(k.removeprefix("conv3x3_"), s[:5]) for calls in plans for k, s in calls
                   if k in chip_smoke.FUSED_KERNELS})


FUSED_SHAPES = _fused_path_shapes()


def test_the_paths_fuse_every_pool_and_upsample():
    pyr = {k: dict(zip(("enc_spec", "dec_spec"), stage_specs("16x", k))) for k in STAGES}
    fused = chip_smoke.path_calls(pyr, STAGES, 2048, 2048)[0]
    sep = chip_smoke.path_calls(pyr, STAGES, 2048, 2048, fused=False)[0]
    total = lambda calls, kinds: sum(n for (k, _), n in calls.items() if k in kinds)
    assert total(sep, ("max_pool_2x2",)) == 20 and total(sep, ("upsample_nearest_2x",)) == 10
    assert total(fused, ("max_pool_2x2", "upsample_nearest_2x")) == 0
    assert (total(fused, ("conv3x3_pool",)), total(fused, ("conv3x3_up",))) == (20, 10)
    assert total(fused, chip_smoke.CONV_KERNELS) == total(sep, ("conv3x3_reflect",)) == 93
    assert {s[3:5] for _, s in FUSED_SHAPES} == {(16, 16), (32, 32), (64, 64), (128, 128)}


@pytest.mark.parametrize("kind,shape", FUSED_SHAPES, ids=str)
def test_fused_plans_at_the_path_shapes(kind, shape):
    n, h, w, ci, co = shape
    plan = kconv.launch_plan(n, h, w, ci, co, N_SM, fuse=kind)
    assert plan == kconv.launch_plan(n, h, w, ci, co, N_SM)
    assert plan.template in kconv.FUSED_TEMPLATES
    th, tw = plan.tile
    assert th % 2 == 0 and tw % 2 == 0 and (kind == "pool" or h % 2 == w % 2 == 0)
    p16 = kconv.launch_plan_bf16(n, h, w, ci, co, N_SM, fuse=kind)
    assert p16 == kconv.launch_plan_bf16(n, h, w, ci, co, N_SM)
    assert p16.template in kconv.BF16_FUSED_TEMPLATES and p16.resident
    assert p16.tile[0] % 2 == 0 and p16.tile[1] % 2 == 0 and co % p16.cout_tile == 0


def test_fused_plans_raise_without_an_instantiation():
    for ci, co in ((256, 256), (512, 512), (3, 24), (24, 3), (129, 64), (3, 3)):
        with pytest.raises(ValueError, match="no fused"):
            kconv.launch_plan(1, 8, 8, ci, co, N_SM, fuse="pool")
    for ci, co in ((256, 256), (3, 16), (16, 8), (24, 3)):
        with pytest.raises(ValueError, match="no fused"):
            kconv.launch_plan_bf16(1, 8, 8, ci, co, N_SM, fuse="up")
    with pytest.raises(ValueError, match="fuse"):
        kconv.launch_plan(1, 8, 8, 16, 16, N_SM, fuse="unpool")
    with pytest.raises(ValueError, match="no fused"):
        kconv.launch_plan_bf16(1, 8, 8, 16, 16, N_SM, taps=1, fuse="pool")
    assert kconv.has_fused(64, 64, torch.float32) and kconv.has_fused(128, 128, BF16)


def test_fused_tables_are_the_sources_instantiations():
    csrc = os.path.join(os.path.dirname(kconv.__file__), "csrc")
    src = open(os.path.join(csrc, "conv3x3.cu")).read()
    entry = src[src.index('extern "C" int cd_conv3x3_fused'):]
    ring = dict((int(t), n) for t, n in re.findall(r"case (\d+):\s*return launch_ring<(\w+)>", src))
    for flags in ("false, true>", "false, false, true>"):
        found = dict((int(t), n) for t, n in
                     re.findall(r"case (\d+):\s*return launch_ring_as<(\w+), " + flags, entry))
        assert set(found) == kconv.FUSED_TEMPLATES
        assert all(ring[t] == n for t, n in found.items())
    src = open(os.path.join(csrc, "conv3x3_bf16.cu")).read()
    entry = src[src.index('extern "C" int cd_conv3x3_bf16_fused'):]
    plain = dict((int(t), n) for t, n in re.findall(r"case (\d+): return run<(\w+)>", src))
    found = re.findall(r"case (\d+):\s*return pool \? run_fused<(\w+), true>\(.*?\)\s*"
                       r": run_fused<(\w+), false>", entry, re.S)
    assert {int(t) for t, _, _ in found} == kconv.BF16_FUSED_TEMPLATES
    assert all(plain[int(t)] == a == b for t, a, b in found)


# ---- the ctypes path, through a stub library -------------------------------------------

def _host(ptr, shape, dtype=torch.float32):
    n = int(np.prod(shape))
    if dtype == BF16:
        raw = (ctypes.c_uint16 * n).from_address(ptr)
        return torch.frombuffer(raw, dtype=torch.int16).view(BF16).view(shape)
    return torch.frombuffer((ctypes.c_float * n).from_address(ptr),
                            dtype=torch.float32).view(shape)


class _StubLibrary:
    """The C entries the route reaches, computed by the plain versions on
    the host memory behind the pointers; the fused ones check the plan."""

    def __init__(self):
        self.fused = []

    def cd_conv3x3_reflect(self, x, w, b, y, top, bot, ts, bs, n, h, wd, cin, cout, relu,
                           template, grid, stream):
        assert top is None and bot is None
        _host(y, (n, h, wd, cout)).copy_(kconv.conv3x3_plain(
            _host(x, (n, h, wd, cin)), _host(w, (3, 3, cin, cout)), _host(b, (cout,)),
            bool(relu)))
        return 0

    def cd_max_pool_2x2(self, x, y, n, h, w, c, stream):
        _host(y, (n, h // 2, w // 2, c)).copy_(kpool.max_pool_2x2_plain(_host(x, (n, h, w, c))))
        return 0

    def cd_upsample_nearest_2x(self, x, y, n, h, w, c, stream):
        _host(y, (n, 2 * h, 2 * w, c)).copy_(
            kpool.upsample_nearest_2x_plain(_host(x, (n, h, w, c))))
        return 0

    def _fused(self, dtype, bias_dtype, x, w, b, y, n, h, wd, cin, cout, relu, tmpl, grid,
               fuse):
        kind = {1: "pool", 2: "up"}[fuse]
        plan = (kconv.launch_plan_bf16(n, h, wd, cin, cout, N_SM, fuse=kind) if dtype == BF16
                else kconv.launch_plan(n, h, wd, cin, cout, N_SM, fuse=kind))
        assert (tmpl, grid) == (plan.template, plan.grid[0])
        self.fused.append((kind, (n, h, wd, cin, cout)))
        xs = (n, h, wd, cin) if kind == "pool" else (n, h // 2, wd // 2, cin)
        ys = (n, h // 2, wd // 2, cout) if kind == "pool" else (n, h, wd, cout)
        plain = kfused.conv3x3_pool_plain if kind == "pool" else kfused.conv3x3_up_plain
        _host(y, ys, dtype).copy_(plain(_host(x, xs, dtype), _host(w, (3, 3, cin, cout), dtype),
                                        _host(b, (cout,), bias_dtype), bool(relu)))
        return 0

    def cd_conv3x3_fused(self, x, w, b, y, n, h, wd, cin, cout, relu, tmpl, grid, fuse, stream):
        return self._fused(torch.float32, torch.float32, x, w, b, y, n, h, wd, cin, cout, relu,
                           tmpl, grid, fuse)

    def cd_conv3x3_bf16_fused(self, x, w, b, y, n, h, wd, cin, cout, relu, bias_bf16, tmpl,
                              grid, resident, fuse, stream):
        assert resident == 1
        return self._fused(BF16, BF16 if bias_bf16 else torch.float32, x, w, b, y, n, h, wd,
                           cin, cout, relu, tmpl, grid, fuse)


@pytest.fixture()
def stub_card(monkeypatch):
    """Every op takes its kernel's launch, through the wrappers' ctypes path
    into a stub library; the fused route on CPU maps."""
    lib = _StubLibrary()
    monkeypatch.setattr(tconv, "on_card", lambda x: True)
    monkeypatch.setattr(tconv, "FUSE_DEVICES", frozenset({"cpu"}))
    refuse = lambda name, *t, rows=(), dtype=None: kconv._refuse_grad(name, *t, *rows)
    for mod in (kconv, kpool, kfused):
        monkeypatch.setattr(mod, "_check_cuda", refuse)
    plan = lambda *a: kconv.launch_plan(*a[:5], N_SM, *a[6:])
    monkeypatch.setattr(kconv, "device_plan", plan)
    monkeypatch.setattr(kfused, "device_plan", plan)
    monkeypatch.setattr(kfused, "device_plan_bf16",
                        lambda *a: kconv.launch_plan_bf16(*a[:5], N_SM, *a[6:]))
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    for k in kc.KERNELS + kc.BF16_KERNELS:
        monkeypatch.setattr(k, "launches", 0)
    return lib


def test_fused_launches_through_ctypes(rng, stub_card):
    """A stage-4 encoder and decoder through the wrappers: the fused
    launches get the conv's map (x's, or twice x's) and the plan's template
    and grid, count in their own counters, and give the separate route's
    output; the pool and upsample kernels never launch."""
    jp, tp = _toy_stage(4)
    x = torch.from_numpy(rng.random((1, 26, 40, 3), np.float32))
    f = tvgg.apply_encoder(tp["enc"], x, tp["enc_spec"], aux=False)["out"]
    out = tvgg.apply_decoder(tp["dec"], f, tp["dec_spec"], taps=False)["out"]
    assert stub_card.fused == [("pool", (1, 26, 40, 16, 16)), ("pool", (1, 13, 20, 32, 32)),
                               ("pool", (1, 6, 10, 64, 64)), ("up", (1, 6, 10, 64, 64)),
                               ("up", (1, 12, 20, 32, 32)), ("up", (1, 24, 40, 16, 16))]
    assert (kc.conv3x3_pool.launches, kc.conv3x3_up.launches) == (3, 3)
    assert kc.max_pool_2x2.launches == kc.upsample_nearest_2x.launches == 0
    assert kc.conv3x3_reflect.launches == 18 - 6   # 9 convs each side
    with torch.no_grad():
        tconv.FUSE_DEVICES = frozenset()
        try:
            f2 = tvgg.apply_encoder(tp["enc"], x, tp["enc_spec"], aux=False)["out"]
            out2 = tvgg.apply_decoder(tp["dec"], f2, tp["dec_spec"], taps=False)["out"]
        finally:
            tconv.FUSE_DEVICES = frozenset({"cpu"})
    assert torch.equal(f, f2) and torch.equal(out, out2)
    assert kc.max_pool_2x2.launches == kc.upsample_nearest_2x.launches == 3


@pytest.mark.parametrize("bias", [BF16, torch.float32, None], ids=str)
def test_fused_bf16_launches_through_ctypes(rng, stub_card, bias):
    x, wt, b = _conv_inputs(rng, 2, 9, 14, 32, 32, BF16)
    b = None if bias is None else b.to(bias)
    got = kc.conv3x3_pool(x, wt, b, True)
    assert got.dtype == BF16 and got.shape == (2, 4, 7, 32)
    assert torch.equal(_bits(got), _bits(kfused.conv3x3_pool_plain(x, wt, b, True)))
    up = kc.conv3x3_up(x, wt, b, False)
    assert up.shape == (2, 18, 28, 32)
    assert torch.equal(_bits(up), _bits(kfused.conv3x3_up_plain(x, wt, b, False)))
    assert (kc.conv3x3_pool_bf16.launches, kc.conv3x3_up_bf16.launches) == (1, 1)
    assert kc.conv3x3_pool.launches == kc.conv3x3_up.launches == 0
    assert stub_card.fused == [("pool", (2, 9, 14, 32, 32)), ("up", (2, 18, 28, 32, 32))]


def test_fused_wrappers_refuse_what_the_kernels_do_not_take(stub_card):
    x = torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError, match="no fused"):
        kc.conv3x3_pool(torch.zeros(1, 4, 4, 256), torch.zeros(3, 3, 256, 256), None, True)
    with pytest.raises(ValueError, match="do not match"):
        kc.conv3x3_up(x, torch.zeros(3, 3, 8, 16), None, True)
    with pytest.raises(ValueError, match="bias"):
        kc.conv3x3_pool(x, torch.zeros(3, 3, 16, 16), torch.zeros(8), True)
    # an empty pooled map: nothing launched
    assert kc.conv3x3_pool(torch.zeros(1, 1, 5, 16), torch.zeros(3, 3, 16, 16), None,
                           True).shape == (1, 0, 2, 16)
    assert kc.conv3x3_pool.launches == 0 and stub_card.fused == []


def test_fused_kernels_count_and_refuse_cpu_tensors():
    assert {k.__name__ for k in kc.KERNELS} >= {"conv3x3_pool", "conv3x3_up"}
    assert {k.__name__ for k in kc.BF16_KERNELS} >= {"conv3x3_pool_bf16", "conv3x3_up_bf16"}
    x, w = torch.zeros(1, 4, 4, 16), torch.zeros(3, 3, 16, 16)
    for call in (lambda: kc.conv3x3_pool(x, w, None, True),
                 lambda: kc.conv3x3_up(x.to(BF16), w.to(BF16), None, True)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert all(k.launches == 0 for k in kc.KERNELS + kc.BF16_KERNELS)
    assert kc.conv3x3_pool.plain is kfused.conv3x3_pool_plain
    assert kc.conv3x3_up_bf16.plain is kfused.conv3x3_up_plain
