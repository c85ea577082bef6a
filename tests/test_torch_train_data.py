"""The PyTorch port's training inputs and training CLI, on the CPU: dataset
items and loader batches bit-equal to the reference package's on PNG files,
PIL's BILINEAR resize bit for bit, and ``cli.train --device cpu`` end to
end on a teacher store written by the reference's ``cli/make_teacher.py``."""

import glob
import os

import numpy as np
import pytest
from PIL import Image

import torch

from collaborative_distillation_tpu.cli import make_teacher
from collaborative_distillation_tpu.data import pipeline as jpipe
from collaborative_distillation_tpu_torch.cli import train as cli
from collaborative_distillation_tpu_torch.data import pipeline as tpipe
from collaborative_distillation_tpu_torch.utils.image import resize


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _photo():
    path = os.path.join(os.path.dirname(tpipe.__file__), "photo_pair_512.npz")
    with np.load(path) as d:
        return d["content"]


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """Six PNG crops of the photo, of several sizes (one under the crop)."""
    d = tmp_path_factory.mktemp("pngs")
    photo = _photo()
    for i, (h, w) in enumerate([(90, 120), (130, 97), (80, 80), (150, 110), (60, 70),
                                (100, 141)]):
        y, x = 40 * i, 30 * i
        Image.fromarray(np.ascontiguousarray(photo[y:y + h, x:x + w])).save(d / f"{i}.png")
    return str(d)


@pytest.mark.parametrize("aug", ["flip", "strong"])
@pytest.mark.parametrize("uint8", [True, False])
def test_image_folder_items_equal_reference(png_dir, aug, uint8):
    kw = dict(shorter_side=84, crop=64, seed=3, uint8=uint8, aug=aug)
    mine, ref = tpipe.ImageFolderDataset(png_dir, **kw), jpipe.ImageFolderDataset(png_dir, **kw)
    for idx in [0, 1, 2, 3, 4, 5, 3, 0, 5, 1, 2, 4]:   # drawn in one order
        (a, pa), (b, pb) = mine[idx], ref[idx]
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape == (64, 64, 3)
        np.testing.assert_array_equal(a, b)


def test_npy_folder_and_loader_equal_reference(png_dir, tmp_path):
    for i, path in enumerate(sorted(glob.glob(os.path.join(png_dir, "*.png")))[:4]):
        np.save(tmp_path / f"{i}.npy", np.asarray(Image.open(path)))
    mine, ref = tpipe.NpyFolderDataset(str(tmp_path), crop=48), jpipe.NpyFolderDataset(
        str(tmp_path), crop=48)
    for idx in [0, 1, 2, 3, 1]:
        np.testing.assert_array_equal(mine[idx][0], ref[idx][0])
    # one decode worker: the datasets draw in the loader's order
    kw = dict(shorter_side=84, crop=64, uint8=True, cache=True)
    batches = [list(L(D(png_dir, **kw), 2, num_workers=1, seed=5))
               for L, D in ((tpipe.Loader, tpipe.ImageFolderDataset),
                            (jpipe.Loader, jpipe.ImageFolderDataset))]
    assert len(batches[0]) == len(batches[1]) == 3
    for (a, pa), (b, pb) in zip(*batches):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [(300, 400, 256, 341), (37, 53, 100, 11), (512, 300, 257, 299),
                                  (64, 64, 64, 128), (90, 120, 90, 119)], ids=str)
def test_bilinear_resize_equals_pil(rng, size):
    h, w, nh, nw = size
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
    np.testing.assert_array_equal(resize(img, nw, nh, "bilinear"), want)
    with pytest.raises(ValueError, match="resample"):
        resize(img, nw, nh, "lanczos")


@pytest.fixture(scope="module")
def teacher_root(tmp_path_factory):
    """A stage-1 teacher store written by the reference's make_teacher."""
    root = tmp_path_factory.mktemp("weights")
    make_teacher.main(["--out", str(root), "--stages", "1", "--n_images", "4",
                       "--size", "64"])
    return str(root)


def test_train_cli_writes_log_grid_and_checkpoint_and_resumes(png_dir, teacher_root, tmp_path,
                                                              monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["--mode", "wct_se", "--stage", "1", "--device", "cpu", "--content_train", png_dir,
            "--weights_root", teacher_root, "-b", "2", "--shorter_side", "72",
            "--print_interval", "1", "--save_interval", "1"]
    assert cli.main(base + ["--max_steps", "2", "-p", "first"]) == 0
    (run,) = glob.glob("Experiments/*_first")
    (log,) = glob.glob(f"{run}/weights/log_*.txt")
    (ckpt,) = glob.glob(f"{run}/weights/*.npz")
    text = open(log).read()
    assert "E1S0" in text and "E1S1" in text and "max_steps 2 reached" in text
    assert len(glob.glob(f"{run}/reconstructed_images/*")) == 2
    with np.load(ckpt) as z:
        keys = set(z.files)
    assert {"opt_state/0/0", "meta/epoch", "meta/mode", "params/conv11/w",
            "opt_state/0/1/conv11_aux/w", "opt_state/0/2/conv11_aux/b"} <= keys
    # six images at batch 2: three steps an epoch; resume at epoch 2
    assert cli.main(base + ["--resume", ckpt, "--epoch", "2", "-p", "second"]) == 0
    (run2,) = glob.glob("Experiments/*_second")
    text = open(glob.glob(f"{run2}/weights/log_*.txt")[0]).read()
    assert "at epoch 1" in text and "E2S2" in text and "E1S0" not in text
    assert "epoch 2 done" in text


def test_train_cli_without_teachers_and_refusals(png_dir, tmp_path, monkeypatch):
    """wct_sd with --lw_perc 0 on the shipped 16x_base weights alone."""
    monkeypatch.chdir(tmp_path)
    argv = ["--mode", "wct_sd", "--stage", "1", "--lw_perc", "0", "--pretrained_init",
            "--content_train", png_dir, "-b", "3", "--shorter_side", "72", "--max_steps", "1",
            "--weights_root", str(tmp_path / "nowhere")]
    with pytest.raises(FileNotFoundError, match="16x_base"):
        cli.main(argv + ["--device", "cpu"])
    argv = argv[:-2]
    assert cli.main(argv + ["--device", "cpu", "-p", "sd"]) == 0
    text = open(glob.glob("Experiments/*_sd/weights/log_*.txt")[0]).read()
    assert "pixl (*1)" in text and "perc" not in text.split("args:")[1].split("\n", 1)[1]
    with pytest.raises(SystemExit, match="ROADMAP"):
        cli.main(argv + ["--device", "cpu", "--bf16"])
    with pytest.raises(SystemExit, match="ROADMAP"):
        cli.main(argv + ["--device", "cpu", "--data_parallel", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu|device='cpu'"):
            cli.main(argv)
