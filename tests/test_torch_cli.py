"""The port's CLIs on the CPU against the reference package's: ``stylize``
over a 2x2 grid of photo-pair crops with the shipped ``16x`` weights (PSNR
>= 40 dB per output, decoded), the single-pair path and its PNG outputs
where the JPEG codec is unavailable, the refused flags, ``--profile``;
``eval`` per-stage numbers within 0.05 dB PSNR and 1e-3 SSIM, with and
without teachers; ``export`` writing the same npz bytes as the reference
from the same checkpoint. Without ``--device cpu`` on a machine without
CUDA, the CLIs that compute raise before doing any work.
"""

import json
import os
import re

import numpy as np
import pytest
from PIL import Image

import jax

from collaborative_distillation_tpu.cli import eval as jeval
from collaborative_distillation_tpu.cli import export as jexport
from collaborative_distillation_tpu.cli import stylize as jstylize
from collaborative_distillation_tpu.models.specs import encoder_spec as jencoder_spec
from collaborative_distillation_tpu.models.vgg import init_params as jinit_params
from collaborative_distillation_tpu.utils.checkpoint import save_checkpoint

import torch

from collaborative_distillation_tpu_torch.cli import eval as teval
from collaborative_distillation_tpu_torch.cli import export as texport
from collaborative_distillation_tpu_torch.cli import serve as tserve
from collaborative_distillation_tpu_torch.cli import stylize as tstylize
from collaborative_distillation_tpu_torch.data import native_codec as tnc
from collaborative_distillation_tpu_torch.data.png import decode_png
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """content/{a.png, b.jpg} (96x128) and style/{x.png, y.jpg} (64x64)
    crops of the photo pair."""
    root = tmp_path_factory.mktemp("grid")
    with np.load(os.path.join(REPO, "collaborative_distillation_tpu_torch", "data",
                              "photo_pair_512.npz")) as d:
        c, s = d["content"], d["style"]
    (root / "content").mkdir()
    (root / "style").mkdir()
    (root / "one").mkdir()
    Image.fromarray(c[100:196, 50:178]).save(root / "content" / "a.png")
    Image.fromarray(c[300:396, 300:428]).save(root / "content" / "b.jpg", quality=95)
    Image.fromarray(s[:64, :64]).save(root / "style" / "x.png")
    Image.fromarray(s[200:264, 100:164]).save(root / "style" / "y.jpg", quality=95)
    Image.fromarray(c[100:196, 50:178]).save(root / "one" / "a.png")
    return root


def _grid_args(grid, out, *extra):
    return ["--mode", "16x", "--contentPath", str(grid / "content"), "--stylePath",
            str(grid / "style"), "--outf", str(out), "--log_mark", "t", *extra]


def _read(path):
    return np.asarray(Image.open(path).convert("RGB"))


def test_stylize_cli_matches_the_reference(grid, tmp_path):
    assert tstylize.main(_grid_args(grid, tmp_path / "port", "--device", "cpu")) == 0
    assert jstylize.main(_grid_args(grid, tmp_path / "ref")) == 0
    names = sorted(f for f in os.listdir(tmp_path / "ref") if f.endswith(".jpg"))
    assert names == sorted(f for f in os.listdir(tmp_path / "port") if f.endswith(".jpg"))
    assert len(names) == 4 and names[0] == "t_mode=16x_alpha=1.0_a+x.jpg"
    for n in names:
        a, b = _read(tmp_path / "port" / n), _read(tmp_path / "ref" / n)
        assert a.shape == b.shape == (96, 128, 3)
        assert _psnr(a, b) >= PSNR_MIN_DB, n


def test_one_pair_writes_png_where_the_codec_is_unavailable(grid, tmp_path, monkeypatch):
    """One pair takes ``stylize(as_uint8=True)``; without the codec its
    ``.jpg`` name is written as ``.png``, bit-equal to the engine's direct
    call, and the log says why."""
    monkeypatch.setattr(tnc, "_lib", None)
    monkeypatch.setattr(tnc, "_reason", "native codec unavailable: no jpeglib.h")
    args = ["--mode", "16x", "--contentPath", str(grid / "one"), "--stylePath",
            str(grid / "one"), "--outf", str(tmp_path), "--log_mark", "one", "--alpha", "0.7",
            "--device", "cpu"]
    assert tstylize.main(args) == 0
    out = tmp_path / "one_mode=16x_alpha=0.7_a+a.png"
    assert sorted(os.listdir(tmp_path)) == ["log_one_16x.txt", out.name]
    log = (tmp_path / "log_one_16x.txt").read_text()
    assert "as PNG: native codec unavailable: no jpeglib.h" in log
    img = _read(grid / "one" / "a.png")
    want = WCTEngine(mode="16x", device="cpu").stylize(img, img, alpha=0.7, as_uint8=True)
    np.testing.assert_array_equal(decode_png(out.read_bytes()), want)


@pytest.mark.parametrize("flags", [["--bf16"], ["--packed"], ["--halo", "pallas"]])
def test_flags_without_a_counterpart_are_refused(flags, capsys):
    with pytest.raises(SystemExit) as e:
        tstylize.main(["--device", "cpu", *flags])
    assert e.value.code == 2
    assert "has no counterpart in the PyTorch port" in capsys.readouterr().err
    text = " ".join(tstylize.build_parser().format_help().split())
    for said in ("refused: bfloat16", "refused: the width-packed", "pallas is refused"):
        assert said in text


def test_space_wants_a_card_per_shard(grid, tmp_path):
    with pytest.raises(ValueError, match="needs 2 devices"):
        tstylize.main(_grid_args(grid, tmp_path, "--device", "cpu", "--space", "2"))


def test_profile_writes_a_trace(grid, tmp_path):
    args = ["--mode", "16x", "--contentPath", str(grid / "one"), "--stylePath",
            str(grid / "one"), "--outf", str(tmp_path / "o"), "--device", "cpu",
            "--profile", str(tmp_path / "prof")]
    assert tstylize.main(args) == 0
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("cli", ["stylize", "serve", "eval"])
def test_every_cli_raises_without_cuda_unless_asked(cli, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"stylize": tstylize.main, "serve": tserve.main, "eval": teval.main}[cli]
    argv = {"stylize": ["--mode", "16x", "--outf", str(tmp_path / "out")],
            "serve": ["--port", "0"], "eval": ["--images", str(tmp_path)]}[cli]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    assert os.listdir(tmp_path) == []   # nothing done before the refusal


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    """A weights root with random ``original`` encoders for stages 2 and 1."""
    root = tmp_path_factory.mktemp("teachers")
    (root / "original").mkdir()
    for k in (2, 1):
        p = jinit_params(jencoder_spec("original", k), jax.random.key(k))
        np.savez(root / "original" / f"e{k}.npz",
                 **{f"{n}/{kind}": np.asarray(a) for n, leaf in p.items()
                    for kind, a in leaf.items()})
    return root


def _ref_eval(argv, capsys):
    capsys.readouterr()
    assert jeval.main(argv) == 0
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        m = re.match(r"stage (\d): (.*)", line)
        if m:
            rows[int(m.group(1))] = {k: float(v) for k, v in
                                     (kv.split("=") for kv in m.group(2).split())}
    return rows


@pytest.mark.parametrize("case", ["all_stages", "teachers"])
def test_eval_matches_the_reference(grid, teachers, case, capsys):
    argv = ["--mode", "16x", "--images", str(grid / "content"), "--size", "64"]
    if case == "teachers":
        argv += ["--stages", "2", "1", "--teacher_root", str(teachers)]
    ours = teval.run(argv + ["--device", "cpu"])
    ref = _ref_eval(argv, capsys)
    assert sorted(ours) == sorted(ref) == ([1, 2] if case == "teachers" else [1, 2, 3, 4, 5])
    for k, row in ours.items():
        assert set(row) == set(ref[k])
        assert abs(row["psnr"] - ref[k]["psnr"]) <= 0.05
        assert abs(row["ssim"] - ref[k]["ssim"]) <= 1e-3
        if case == "teachers":
            assert row["feat_mse"] == pytest.approx(ref[k]["feat_mse"], rel=1e-3)


def test_export_writes_the_references_npz(tmp_path, capsys):
    rng = np.random.default_rng(0)
    tree = {"params": {"conv11": {"w": rng.random((3, 3, 3, 16), np.float32),
                                  "b": rng.random(16, np.float32)},
                       "conv12": {"w": rng.random((3, 3, 16, 16), np.float32),
                                  "b": rng.random(16, np.float32)}},
            "opt_state": {"mu": rng.random(5, np.float32)},
            "meta": {"mode": "wct_sd", "stage": 2, "epoch": np.int64(3),
                     "step": np.int64(1200)}}
    save_checkpoint(str(tmp_path / "ckpt"), tree)
    assert texport.main([str(tmp_path / "ckpt"), "--out", str(tmp_path / "t" / "d2.npz")]) == 0
    assert jexport.main([str(tmp_path / "ckpt.npz"), "--out", str(tmp_path / "j.npz")]) == 0
    assert (tmp_path / "t" / "d2.npz").read_bytes() == (tmp_path / "j.npz").read_bytes()
    assert (texport.export_student(str(tmp_path / "ckpt"), str(tmp_path / "again.npz"))
            == jexport.export_student(str(tmp_path / "ckpt"), str(tmp_path / "j2.npz")))
    with np.load(tmp_path / "t" / "d2.npz") as d:
        assert sorted(d.files) == ["conv11/b", "conv11/w", "conv12/b", "conv12/w"]
    np.savez(tmp_path / "bad.npz", x=np.zeros(2))
    with pytest.raises(SystemExit, match="no 'params/' leaves"):
        texport.export_student(str(tmp_path / "bad.npz"), str(tmp_path / "o.npz"))
