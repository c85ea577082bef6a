"""The PyTorch port's weight converters against the reference's, on the CPU:
``utils/torch_convert.py``, ``cli/convert.py``, ``cli/convert_caffe.py`` and
``cli/convert_mobilenet.py``.

* ``.pth`` state dicts in the zip and the legacy (torch 0.4.1, non-zip)
  format, wrapped as ``{"epoch", "model"}`` and bare, convert to bit-equal
  trees; a file that needs arbitrary unpickling is refused by the port
  (``weights_only=True``), where the reference loads it;
* ``cli.convert`` over a fake ``trained_models/`` tree (students in every
  format, ``.t7`` teachers, an ``our_BD`` decoder, absent files) writes
  identical stores through both CLIs and the same ``[missing]`` lines;
* ``cli.convert_caffe`` and ``cli.convert_mobilenet``: identical npz files
  through both CLIs.
"""

import argparse
import os

import numpy as np
import pytest

from collaborative_distillation_tpu.cli import convert as jax_convert
from collaborative_distillation_tpu.cli import convert_caffe as jax_convert_caffe
from collaborative_distillation_tpu.cli import convert_mobilenet as jax_convert_mobilenet
from collaborative_distillation_tpu.utils import torch_convert as jax_torch_convert

import torch
from torch import nn

from collaborative_distillation_tpu_torch.cli import convert, convert_caffe, convert_mobilenet
from collaborative_distillation_tpu_torch.models.mobilenet import MOBILENET_BLOCKS
from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
from collaborative_distillation_tpu_torch.models.zoo import load_stage_params
from collaborative_distillation_tpu_torch.utils import torch_convert
from t7_synth import write_teacher_t7
from test_caffe import _vgg_layers, write_caffemodel


def _state_dict(spec, rng):
    """A torch state dict (OIHW) with ``spec``'s layers, seeded."""
    return {f"{n}.{k}": torch.from_numpy(
        rng.standard_normal(ws if k == "weight" else bs).astype(np.float32)
        .transpose((3, 2, 0, 1) if k == "weight" else (0,)).copy())
        for n, (ws, bs) in sorted(spec.param_shapes().items()) for k in ("weight", "bias")}


def _save(obj, path, fmt):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(obj, path, _use_new_zipfile_serialization=(fmt == "zip"))


def _store(root):
    """{relative path: {key: array}} of every npz under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with np.load(os.path.join(d, f)) as z:
                out[os.path.relpath(os.path.join(d, f), root)] = {k: z[k] for k in z.files}
    return out


def _assert_same_store(got, want):
    assert sorted(got) == sorted(want)
    for f in want:
        assert sorted(got[f]) == sorted(want[f]), f
        for k in want[f]:
            g, w = got[f][k], want[f][k]
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), (f, k)


@pytest.mark.parametrize("fmt", ["zip", "legacy"])
@pytest.mark.parametrize("wrapped", [True, False])
def test_pth_formats_convert_bit_equal(tmp_path, rng, fmt, wrapped):
    sd = _state_dict(encoder_spec("16x", 2, aux=True), rng)
    path = str(tmp_path / "m" / "2SE.pth")
    _save({"epoch": 30, "model": sd} if wrapped else sd, path, fmt)
    got, want = torch_convert.convert_pth(path), jax_torch_convert.convert_pth(path)
    assert sorted(got) == sorted(want)
    for name in want:
        for kind in ("w", "b"):
            assert got[name][kind].dtype == np.float32
            np.testing.assert_array_equal(got[name][kind], want[name][kind])
    assert got["conv21"]["w"].shape == (3, 3, 16, 32)


def test_pth_needing_arbitrary_unpickling_is_refused(tmp_path, rng):
    sd = _state_dict(encoder_spec("16x", 1, aux=True), rng)
    path = str(tmp_path / "args.pth")
    torch.save({"args": argparse.Namespace(lr=1e-4), "model": sd}, path)
    assert sorted(jax_torch_convert.convert_pth(path)) == sorted(
        {k.rsplit(".", 1)[0] for k in sd})   # the reference unpickles anything
    with pytest.raises(torch_convert.UnsafeCheckpoint, match="refused"):
        torch_convert.convert_pth(path)
    with pytest.raises(ValueError, match="arbitrary unpickling"):
        convert_mobilenet.load_state_dict(path)


def _fake_trained_models(root, rng):
    """The reference's trained_models/ layout: 16x students in zip and
    legacy format, wrapped and bare; kd2sd decoders and pruned bases for
    stages 1-2; stage-1 and -2 teacher encoders as .t7, the stage-1 decoder
    as .t7 and the stage-2 one as an our_BD .pth; the rest absent."""
    fmts = ["zip", "legacy"]
    for k in range(1, 6):
        _save({"epoch": k, "model": _state_dict(encoder_spec("16x", k, aux=True), rng)},
              os.path.join(root, "wct_se_16x_new", f"{k}SE.pth"), fmts[k % 2])
        _save(_state_dict(decoder_spec("16x", k), rng),
              os.path.join(root, "wct_se_16x_new_sd", f"{k}SD.pth"), fmts[(k + 1) % 2])
    for k in (1, 2):
        _save(_state_dict(decoder_spec("16x", k, aux=True), rng),
              os.path.join(root, "wct_se_16x_new_sd_kd2sd", f"{k}SD.pth"), "legacy")
        _save({"epoch": 0, "model": _state_dict(encoder_spec("16x", k, aux=True), rng)},
              os.path.join(root, "small16x_ae_base", f"e{k}_base.pth"), "zip")
        _save(_state_dict(decoder_spec("16x", k), rng),
              os.path.join(root, "small16x_ae_base", f"d{k}_base.pth"), "legacy")
        espec = encoder_spec("original", k)
        enc = {n: {"w": rng.standard_normal(ws), "b": rng.standard_normal(bs)}
               for n, (ws, bs) in espec.param_shapes().items()}
        os.makedirs(os.path.join(root, "original_wct_models"), exist_ok=True)
        write_teacher_t7(os.path.join(root, "original_wct_models",
                                      f"vgg_normalised_conv{k}_1.t7"),
                         torch_convert.T7_ENCODER_LAYER_INDEX[k], enc)
    dspec = decoder_spec("original", 1)
    write_teacher_t7(os.path.join(root, "original_wct_models", "feature_invertor_conv1_1.t7"),
                     torch_convert.T7_DECODER_LAYER_INDEX[1],
                     {n: {"w": rng.standard_normal(ws), "b": rng.standard_normal(bs)}
                      for n, (ws, bs) in dspec.param_shapes().items()})
    _save({"epoch": 30, "model": _state_dict(decoder_spec("original", 2), rng)},
          os.path.join(root, "our_BD", "2BD_E30S0.pth"), "legacy")


def test_convert_cli_same_store_and_missing_lines(tmp_path, rng, capsys):
    ref = str(tmp_path / "trained_models")
    _fake_trained_models(ref, rng)
    out_port, out_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    assert convert.main(["--reference", ref, "--out", out_port]) == 0
    port_log = capsys.readouterr().out
    assert jax_convert.main(["--reference", ref, "--out", out_jax]) == 0
    jax_log = capsys.readouterr().out
    assert port_log.replace(out_port, "OUT") == jax_log.replace(out_jax, "OUT")
    missing = [l for l in port_log.splitlines() if "[missing]" in l]
    assert len(missing) == 3 + 6 + 3 + 3   # kd2sd, e/d bases, teacher e/d at stages 3-5
    assert "2BD_E30S0.pth ->" in port_log   # no .t7 decoder at stage 2: our_BD's
    got, want = _store(out_port), _store(out_jax)
    assert len(want) == 10 + 2 + 4 + 4
    _assert_same_store(got, want)
    # the zoo reads what the port wrote
    load_stage_params(os.path.join(out_port, "16x", "e5.npz"), encoder_spec("16x", 5, aux=True))
    load_stage_params(os.path.join(out_port, "original", "e2.npz"), encoder_spec("original", 2))
    load_stage_params(os.path.join(out_port, "original", "d2.npz"), decoder_spec("original", 2))


def test_convert_caffe_cli_same_store(tmp_path, rng, capsys):
    src = str(tmp_path / "vgg.caffemodel")
    write_caffemodel(src, _vgg_layers(rng), legacy=True)
    for mod, tag in ((convert_caffe, "port"), (jax_convert_caffe, "jax")):
        assert mod.main(["--caffemodel", src, "--out", str(tmp_path / tag), "--stages", "2",
                         "1", "--dump", str(tmp_path / f"raw_{tag}.npz")]) == 0
    logs = capsys.readouterr().out
    assert logs.count("stage 2: 3 convs") == 2
    _assert_same_store(_store(str(tmp_path / "port")), _store(str(tmp_path / "jax")))
    with np.load(tmp_path / "raw_port.npz") as a, np.load(tmp_path / "raw_jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].tobytes() == b[k].tobytes() and a[k].shape == b[k].shape
    layers = _vgg_layers(rng, stages=("1_1",))
    layers["deconv1_1"] = layers["conv1_1"]
    with pytest.raises(ValueError, match="both map to"):
        convert_caffe.stage_tree(layers, encoder_spec("original", 1))
    assert convert_caffe.caffe_to_store_name("vgg/conv4_3") == "conv43"
    assert convert_caffe.caffe_to_store_name("conv1_1_bn") is None


def test_convert_mobilenet_cli_same_npz(tmp_path, capsys):
    def block(cin, cout, stride, first):
        if first:
            return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, 1, bias=False),
                                 nn.BatchNorm2d(cout), nn.ReLU())
        return nn.Sequential(nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False),
                             nn.BatchNorm2d(cin), nn.ReLU(), nn.Conv2d(cin, cout, 1, bias=False),
                             nn.BatchNorm2d(cout), nn.ReLU())

    torch.manual_seed(0)
    model = nn.Sequential(*(block(*b, i == 0) for i, b in enumerate(MOBILENET_BLOCKS)))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.3, 0.3)
    ckpt = str(tmp_path / "mobilenet_sgd.pth")
    torch.save({"state_dict": {f"module.model.{k}": v for k, v in model.state_dict().items()}},
               ckpt)
    for mod, tag in ((convert_mobilenet, "port"), (jax_convert_mobilenet, "jax")):
        assert mod.main([ckpt, "--out-dir", str(tmp_path / tag)]) == 0
    capsys.readouterr()
    got, want = _store(str(tmp_path / "port")), _store(str(tmp_path / "jax"))
    assert sorted(want) == [f"mobilenet_sgd_my_e{k}.npz" for k in range(1, 6)]
    _assert_same_store(got, want)
