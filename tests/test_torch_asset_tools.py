"""The PyTorch port's ``cli.imgtools`` and ``cli.plot_loss`` against the
reference's, on the CPU.

* ``imgtools crop-center`` and ``resize`` on a folder of PNGs and JPEGs
  (4:2:0 and 4:4:4, odd sizes, PIL-written), the port with ``--device cpu``:
  the same files written, with the same printed lines; PNG pixels bit-equal
  to the reference's (PIL's); JPEG files of the same size whose decoded
  pixels are equal too. The tolerance found for JPEG is 0 levels: on the CPU
  both tools decode with libjpeg and encode with libjpeg at PIL's defaults
  (quality 75, 4:2:0, baseline, no optimized tables), so the coefficients,
  and the files' lengths, are the same.
* ``plot_loss``: ``parse_log`` and ``smooth`` equal to the reference's on
  the same logs, the empty log's exit code and message the same, and the
  SVG parses as XML with one polyline a curve.
"""

import os
import re
import shutil
import xml.etree.ElementTree as ET

import numpy as np
import pytest
from PIL import Image

from collaborative_distillation_tpu.cli import imgtools as jax_imgtools
from collaborative_distillation_tpu.cli import plot_loss as jax_plot_loss

import torch  # noqa: F401  (after JAX)

from collaborative_distillation_tpu_torch.cli import imgtools, plot_loss
from collaborative_distillation_tpu_torch.data import native_codec


def _images(folder, rng):
    os.makedirs(folder)
    y, x = np.mgrid[0:141, 0:203]
    img = np.stack([(np.sin(x / 13.0) + 1) * 120, (np.cos(y / 7.0) + 1) * 120, (x + y) % 256],
                   -1)
    img = np.clip(img + rng.integers(-20, 20, img.shape), 0, 255).astype(np.uint8)
    Image.fromarray(img).save(os.path.join(folder, "wide.png"))
    Image.fromarray(img[:, :97]).save(os.path.join(folder, "tall.png"))
    Image.fromarray(img).save(os.path.join(folder, "photo.jpg"), quality=90)
    Image.fromarray(img[:99, :]).save(os.path.join(folder, "c444.jpeg"), quality=95,
                                      subsampling=0)
    open(os.path.join(folder, "notes.txt"), "w").write("not an image\n")


@pytest.mark.skipif(not native_codec.available(), reason="no libjpeg on this host")
def test_imgtools_files_equal_the_reference(tmp_path, rng, capsys):
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    _images(ref, rng)
    shutil.copytree(ref, port)
    for argv in (["crop-center"], ["resize", "--size", "64", "48"],
                 ["crop-center", "--suffix", "_sq"]):
        assert jax_imgtools.main([argv[0], ref] + argv[1:]) == 0
        want = capsys.readouterr().out
        assert imgtools.main([argv[0], port] + argv[1:] + ["--device", "cpu"]) == 0
        assert capsys.readouterr().out.replace(port, "DIR") == want.replace(ref, "DIR")
    files = sorted(os.listdir(ref))
    assert files == sorted(os.listdir(port)) and len(files) == 5 + 4 + 8 + 16
    jpeg_max = 0
    for f in files:
        if f.endswith(".txt"):
            continue
        a = np.asarray(Image.open(os.path.join(ref, f)).convert("RGB"))
        b = np.asarray(Image.open(os.path.join(port, f)).convert("RGB"))
        assert a.shape == b.shape, f
        if f.endswith(".png"):
            assert np.array_equal(a, b), f
        else:
            jpeg_max = max(jpeg_max, int(np.abs(a.astype(int) - b.astype(int)).max()))
            assert os.path.getsize(os.path.join(ref, f)) == os.path.getsize(
                os.path.join(port, f)), f
    assert jpeg_max == 0
    assert Image.open(os.path.join(port, "photo_resized.jpg")).size == (64, 48)
    assert Image.open(os.path.join(port, "tall_cropped.png")).size == (97, 97)


def test_imgtools_refuses_the_card_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        imgtools.main(["crop-center", str(tmp_path)])


LOG = (
    "[abc 1 2026/01/01-00:00:00] args: {...}\n"
    "[abc 1 2026/01/01-00:00:01] E1S0 feat (*10): 5.657 | pixl (*1): 0.197 (23.45 s/step)\n"
    "[abc 1 2026/01/01-00:00:02] E1S10 feat (*10): 5.535 | pixl (*1): 0.190 (17.47 s/step)\n"
    "[abc 1 2026/01/01-00:00:03] epoch 1 done; checkpoint at x.npz\n"
    "E2S0 perc (*1): 1.25e+01 | feat (*10): 4.5 | pixl (*1): 1.5e-01\n"
    "a line with S and | but no step\n"
    "E2S5 nothing to parse | here\n"
)


def _rng_log(path, rng, n=40):
    with open(path, "w") as fh:
        for i in range(n):
            fh.write(f"[run 1 2026/01/01-00:00:{i:02d}] E{1 + i // 10}S{i % 10 * 10} "
                     f"feat (*10): {rng.random() * 5:.6f} | pixl (*1): "
                     f"{rng.random():.4e} | kd (*1): {rng.random() * 1e-3:.3e} (0.5 s/step)\n")


def test_parse_log_and_smooth_equal_the_reference(tmp_path, rng):
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    open(a, "w").write(LOG)
    _rng_log(b, rng)
    for path in (a, b):
        got, want = plot_loss.parse_log(path), jax_plot_loss.parse_log(path)
        assert got == want and list(got) == list(want)
        for pts in want.values():
            vals = [v for _, v in pts]
            for window in (1, 3, 10):
                assert plot_loss.smooth(vals, window) == jax_plot_loss.smooth(vals, window)
    assert [v for _, v in plot_loss.parse_log(a)["feat"]] == [5.657, 5.535, 4.5]


def test_plot_loss_svg_and_empty_log(tmp_path, rng, capsys):
    a, b = str(tmp_path / "log_a.txt"), str(tmp_path / "log_b.txt")
    open(a, "w").write(LOG)
    _rng_log(b, rng)
    for logs, logy in (([a], False), ([a, b], True)):
        out = str(tmp_path / f"loss{len(logs)}.svg")
        assert plot_loss.main(logs + ["--out", out, "--window", "3"]
                              + (["--logy"] if logy else [])) == 0
        curves = {f"{os.path.basename(p)}:{n}" if len(logs) > 1 else n: pts
                  for p in logs for n, pts in jax_plot_loss.parse_log(p).items()}
        root = ET.parse(out).getroot()
        ns = "{http://www.w3.org/2000/svg}"
        lines = root.findall(f"{ns}polyline")
        assert [l.get("data-label") for l in lines] == list(curves)
        for line in lines:
            pts = line.get("points").split()
            assert len(pts) == len(curves[line.get("data-label")])
            xy = np.array([p.split(",") for p in pts], float)
            assert np.isfinite(xy).all() and (np.diff(xy[:, 0]) > 0).all()
        texts = [t.text for t in root.iter(f"{ns}text")]
        assert "logged step" in texts and any(t.startswith("loss (moving avg)") for t in texts)
        assert re.search(rf"wrote {re.escape(out)} \({len(curves)} curves\)",
                         capsys.readouterr().out)
    empty = str(tmp_path / "empty.txt")
    open(empty, "w").write("nothing here\n")
    assert jax_plot_loss.main([empty, "--out", str(tmp_path / "x.png")]) == 1
    want = capsys.readouterr().err
    assert plot_loss.main([empty, "--out", str(tmp_path / "x.svg")]) == 1
    assert capsys.readouterr().err == want == "no loss lines found in the given logs\n"
    assert not os.path.exists(tmp_path / "x.svg")
    with pytest.raises(SystemExit) as e:
        plot_loss.main([a, "--out", str(tmp_path / "x.png")])
    assert e.value.code == 2
