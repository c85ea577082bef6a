"""Encoders, decoders, specs and the weight zoo of the PyTorch port against
the reference package, on the CPU.

Parameters cross over through ``params_from_jax``. Activations are held to
1e-5 of each map's largest magnitude: every layer matches near float32
epsilon (tests/test_torch_kernels.py), and up to 17 layers compound it.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from collaborative_distillation_tpu.models import specs as jspecs
from collaborative_distillation_tpu.models import vgg as jvgg
from collaborative_distillation_tpu.models import zoo as jzoo

import torch

from collaborative_distillation_tpu_torch.models import specs as tspecs
from collaborative_distillation_tpu_torch.models import vgg as tvgg
from collaborative_distillation_tpu_torch.models import zoo as tzoo
from collaborative_distillation_tpu_torch.utils.params import (
    params_from_jax, pyramid_from_jax, spec_from_jax)

FIXTURE = os.path.join(os.path.dirname(__file__), "golden_fixtures.npz")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _np_stage(jp):
    return {**jp, "enc": _np_tree(jp["enc"]), "dec": _np_tree(jp["dec"])}


def _close_maps(got: dict, want: dict, rel=1e-5):
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=rel, atol=rel * max(np.abs(w).max(), 1e-3),
                                   err_msg=key)


@pytest.fixture(scope="module")
def jax_pyramids(weights_root):
    return {mode: jzoo.load_pyramid(mode, weights_root) for mode in ("16x", "16x_base")}


@pytest.mark.parametrize("mode", ["16x", "16x_base"])
@pytest.mark.parametrize("stage", [1, 2, 3, 4, 5])
def test_encoder_decoder_match_reference(jax_pyramids, rng, mode, stage):
    jp = jax_pyramids[mode][stage]
    tp = pyramid_from_jax({stage: _np_stage(jp)})[stage]
    x = rng.random((1, 32, 48, 3)).astype(np.float32)
    j_enc = jvgg.apply_encoder(jp["enc"], jnp.asarray(x), jp["enc_spec"])
    t_enc = tvgg.apply_encoder(tp["enc"], torch.from_numpy(x), tp["enc_spec"])
    _close_maps(t_enc, j_enc)
    feat = np.array(j_enc["out"])
    j_dec = jvgg.apply_decoder(jp["dec"], jnp.asarray(feat), jp["dec_spec"])
    t_dec = tvgg.apply_decoder(tp["dec"], torch.from_numpy(feat), tp["dec_spec"])
    _close_maps(t_dec, j_dec)


@pytest.mark.parametrize("stage", [1, 2, 3, 4, 5])
def test_one_pixel_reflect_through_every_stage(jax_pyramids, rng, stage):
    """A 16x16 input reaches conv51 at 1x1 (and conv41 at 2x2, ...): the
    size-1 reflect pad where jnp.pad and F.pad(mode="reflect") disagree."""
    jp = jax_pyramids["16x"][stage]
    tp = pyramid_from_jax({stage: _np_stage(jp)})[stage]
    x = rng.random((1, 16, 16, 3)).astype(np.float32)
    j_enc = jvgg.apply_encoder(jp["enc"], jnp.asarray(x), jp["enc_spec"])
    t_enc = tvgg.apply_encoder(tp["enc"], torch.from_numpy(x), tp["enc_spec"])
    assert t_enc["out"].shape[1:3] == (16 >> (stage - 1),) * 2
    _close_maps(t_enc, j_enc)
    feat = np.array(j_enc["out"])
    j_dec = jvgg.apply_decoder(jp["dec"], jnp.asarray(feat), jp["dec_spec"])
    t_dec = tvgg.apply_decoder(tp["dec"], torch.from_numpy(feat), tp["dec_spec"])
    _close_maps(t_dec, j_dec)


@pytest.mark.parametrize("aux_relu,final_relu", [(True, False), (False, False)])
def test_decoder_options_match_reference(rng, aux_relu, final_relu):
    """kd2sd decoder aux adapters, aux_relu and the no-final-ReLU variant."""
    espec, dspec = jzoo.stage_specs("16x_kd2sd", 3)
    params = jvgg.init_params(dspec, jax.random.PRNGKey(0))
    x = rng.standard_normal((1, 8, 8, dspec.layers[0].in_ch)).astype(np.float32)
    want = jvgg.apply_decoder(params, jnp.asarray(x), dspec, aux_relu=aux_relu,
                              final_relu=final_relu)
    got = tvgg.apply_decoder(params_from_jax(_np_tree(params)), torch.from_numpy(x),
                             spec_from_jax(dspec), aux_relu=aux_relu, final_relu=final_relu)
    _close_maps(got, want)
    assert (got["out"] < 0).any()  # no final ReLU: negatives survive


def test_golden_fixtures(weights_root):
    """The captured activations of tests/golden_fixtures.npz, as
    tests/test_golden_fixtures.py pins them for the reference."""
    with np.load(FIXTURE) as data:
        golden = {k: data[k] for k in data.files}
    for stage in (1, 3, 5):
        espec, dspec = tzoo.stage_specs("16x", stage)
        enc = tzoo.load_stage_params(os.path.join(weights_root, "16x", f"e{stage}.npz"), espec)
        dec = tzoo.load_stage_params(os.path.join(weights_root, "16x", f"d{stage}.npz"), dspec)
        outs = tvgg.apply_encoder(enc, torch.from_numpy(golden["input"][None]), espec)
        for key, got in [(f"e{stage}_out", outs["out"]), (f"e{stage}_aux", outs[f"aux{stage}1"])]:
            ref = golden[key]
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * max(np.abs(ref).max(), 1e-3),
                                       err_msg=key)
        rec = tvgg.apply_decoder(dec, outs["out"], dspec)["out"]
        np.testing.assert_allclose(rec.numpy(), golden[f"d{stage}_rec"], atol=1e-4)


@pytest.mark.parametrize("family", ["original", "16x"])
@pytest.mark.parametrize("stage", [1, 3, 5])
def test_specs_are_the_reference_specs(family, stage):
    for aux in (False, True) if family == "16x" else (False,):
        for name in ("encoder_spec", "decoder_spec"):
            want = getattr(jspecs, name)(family, stage, aux=aux)
            got = getattr(tspecs, name)(family, stage, aux=aux)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert spec_from_jax(want) == got


def test_zoo_loads_what_the_reference_loads(weights_root):
    for mode in ("16x", "16x_base"):
        jp = jzoo.load_pyramid(mode, weights_root, stages=(2, 4))
        tp = tzoo.load_pyramid(mode, weights_root, stages=(2, 4))
        for k in (2, 4):
            for part in ("enc", "dec"):
                assert set(tp[k][part]) == set(jp[k][part])
                for name, leaf in jp[k][part].items():
                    for kind in ("w", "b"):
                        np.testing.assert_array_equal(tp[k][part][name][kind].numpy(),
                                                      np.asarray(leaf[kind]))


def test_zoo_fills_missing_aux_and_conv0(tmp_path):
    """Missing aux layers load as zeros; a missing conv0 falls back to the
    hardcoded preprocessing conv (zoo.py:131-136 of the reference)."""
    espec, _ = tzoo.stage_specs("16x", 2)
    g = np.random.default_rng(0)
    arrays = {}
    for name, (ws, bs) in espec.param_shapes().items():
        if name == "conv0" or name.endswith("_aux"):
            continue
        arrays[f"{name}/w"] = g.standard_normal(ws).astype(np.float32)
        arrays[f"{name}/b"] = g.standard_normal(bs).astype(np.float32)
    path = str(tmp_path / "e2.npz")
    np.savez(path, **arrays)
    got = tzoo.load_stage_params(path, espec)
    want = jzoo.load_stage_params(path, jspecs.encoder_spec("16x", 2, aux=True))
    for name in want:
        for kind in ("w", "b"):
            np.testing.assert_array_equal(got[name][kind].numpy(), np.asarray(want[name][kind]))
    assert not got["conv11_aux"]["w"].any()
    np.testing.assert_array_equal(got["conv0"]["w"].numpy(), tzoo.PREPROC_CONV0["w"])
    with pytest.raises(FileNotFoundError):
        tzoo.load_stage_params(str(tmp_path / "missing.npz"), espec)


def test_init_params_and_modules():
    espec, dspec = tzoo.stage_specs("16x", 2)
    p1 = tvgg.init_params(espec, torch.Generator().manual_seed(3))
    p2 = tvgg.init_params(espec, torch.Generator().manual_seed(3))
    for name, (ws, bs) in espec.param_shapes().items():
        assert tuple(p1[name]["w"].shape) == ws and tuple(p1[name]["b"].shape) == bs
        assert torch.equal(p1[name]["w"], p2[name]["w"])
        bound = (3.0 / (ws[0] * ws[1] * ws[2])) ** 0.5
        assert float(p1[name]["w"].abs().max()) <= bound
    x = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    enc = tvgg.Encoder(espec, p1)
    got = enc(x)
    want = tvgg.apply_encoder(p1, x, espec)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    lean = enc(x, aux=False)
    assert set(lean) == {k for k in want if not k.startswith("aux")}
    assert torch.equal(lean["out"], want["out"])
    dec = tvgg.Decoder(dspec, generator=torch.Generator().manual_seed(4))
    assert dec(got["out"])["out"].shape == (1, 16, 16, 3)
    assert not any(p.requires_grad for p in dec.parameters())
    with pytest.raises(ValueError):
        tvgg.Encoder(espec)
