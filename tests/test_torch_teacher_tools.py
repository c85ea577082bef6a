"""The teacher-store tools of the PyTorch port (``cli/normalize_vgg.py``,
``cli/make_teacher.py``, ``models/zoo.py:save_tree_npz``), on the CPU:

* ``synth_calibration_batches``: bit-equal to the reference's for the same
  seed;
* ``normalize_encoder``: against the reference's on the same numpy params
  and calibration batches, stages 1 and 3 (teacher widths to 256), every
  leaf within 1e-4 of its largest magnitude (float32 taps in another order,
  compounded over the layers);
* ``cli.make_teacher``: a store that the zoo loads and ``cli.train`` takes
  for a CPU step, whose every filter not floored has mean activation 1 over
  its calibration set within 1e-3 (tests/test_tools.py::
  test_normalize_encoder_unit_mean_activation holds the reference to it).
"""

import os

import numpy as np
import pytest

import jax

from collaborative_distillation_tpu.cli import make_teacher as jax_make_teacher
from collaborative_distillation_tpu.cli.normalize_vgg import normalize_encoder as jax_normalize
from collaborative_distillation_tpu.models.specs import encoder_spec as jax_encoder_spec
from collaborative_distillation_tpu.models.vgg import init_params as jax_init_params
from collaborative_distillation_tpu.models.zoo import PREPROC_CONV0 as JAX_CONV0

import torch

from collaborative_distillation_tpu_torch.cli import make_teacher, normalize_vgg
from collaborative_distillation_tpu_torch.cli import train as train_cli
from collaborative_distillation_tpu_torch.models.specs import encoder_spec
from collaborative_distillation_tpu_torch.models.zoo import (PREPROC_CONV0, load_pyramid,
                                                             load_stage_params, load_tree_npz,
                                                             save_tree_npz)
from collaborative_distillation_tpu_torch.utils.image import save_image
from collaborative_distillation_tpu_torch.utils.params import params_from_jax
from collaborative_distillation_tpu_torch.wct import slab as tslab

LEAF_TOL = 1e-4
UNIT_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_images,batch,size,seed", [(16, 4, 128, 0), (5, 2, 48, 3),
                                                      (3, 4, 32, 11)])
def test_calibration_batches_equal_reference(n_images, batch, size, seed):
    got = make_teacher.synth_calibration_batches(n_images, batch, size, seed)
    want = jax_make_teacher.synth_calibration_batches(n_images, batch, size, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("stage,rel_floor", [(1, 0.0), (3, 1e-2)])
def test_normalize_encoder_equals_reference(stage, rel_floor):
    jspec = jax_encoder_spec("original", stage)
    params = jax.tree.map(np.asarray, jax_init_params(jspec, jax.random.key(stage)))
    params["conv0"] = {k: np.asarray(v) for k, v in JAX_CONV0.items()}
    batches = make_teacher.synth_calibration_batches(4, 2, 32, seed=stage)
    want = jax_normalize(params, jspec, batches, rel_floor=rel_floor)
    got = normalize_vgg.normalize_encoder(params_from_jax(params),
                                          encoder_spec("original", stage), batches,
                                          rel_floor=rel_floor)
    assert set(got) == set(want)
    for name, leaf in want.items():
        for kind, w in leaf.items():
            g = got[name][kind].numpy()
            scale = float(np.abs(w).max())
            assert float(np.abs(g - w).max()) <= LEAF_TOL * scale, (name, kind)


def _layer_means(params, spec, batches):
    """Every conv layer's per-filter mean activation over ``batches``."""
    return {layer.name: sum(normalize_vgg._layer_mean(params, spec, torch.from_numpy(b),
                                                      layer.name).double() * len(b)
                            for b in batches) / sum(len(b) for b in batches)
            for layer in spec.layers}


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("teacher")
    argv = ["--out", str(root), "--stages", "1", "2", "--n_images", "4", "--batch", "2",
            "--size", "48", "--seed", "5"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_teacher.main(argv)   # the card by default
    assert make_teacher.main(argv + ["--device", "cpu"]) == 0
    return str(root)


def test_make_teacher_store_has_unit_mean_activation(store):
    batches = make_teacher.synth_calibration_batches(4, 2, 48, 5)
    for stage in (1, 2):
        spec = encoder_spec("original", stage)
        params = load_stage_params(os.path.join(store, "original", f"e{stage}.npz"), spec)
        np.testing.assert_array_equal(params["conv0"]["w"].numpy(), PREPROC_CONV0["w"])
        for name, m in _layer_means(params, spec, batches).items():
            m = m.numpy()
            floored = m < 1.0 - UNIT_TOL   # near-dead filters, floored at 1e-2 x the mean
            assert floored.mean() < 0.5, name
            np.testing.assert_allclose(m[~floored], 1.0, rtol=0, atol=UNIT_TOL, err_msg=name)
    pyr = load_pyramid("original", store, stages=(2, 1))
    assert set(pyr) == {1, 2} and pyr[2]["dec"]["conv11"]["w"].shape == (3, 3, 64, 3)


def test_make_teacher_is_seeded_and_trains_one_step(store, tmp_path, monkeypatch):
    again = tmp_path / "again"
    assert make_teacher.main(["--out", str(again), "--stages", "1", "--n_images", "4",
                              "--batch", "2", "--size", "48", "--seed", "5",
                              "--device", "cpu"]) == 0
    for part in ("e1", "d1"):
        a = load_tree_npz(os.path.join(store, "original", f"{part}.npz"))
        b = load_tree_npz(os.path.join(again, "original", f"{part}.npz"))
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(a[name]["w"], b[name]["w"])
    # cli.train takes the store as its teachers for one CPU step
    with np.load(os.path.join(os.path.dirname(tslab.__file__), os.pardir, "data",
                              "photo_pair_512.npz")) as d:
        photo = d["content"]
    pngs = tmp_path / "pngs"
    pngs.mkdir()
    for i in range(2):
        save_image(np.ascontiguousarray(photo[60 * i:60 * i + 90, 40 * i:40 * i + 100]),
                   str(pngs / f"{i}.png"))
    monkeypatch.chdir(tmp_path)
    assert train_cli.main(["--mode", "wct_se", "--stage", "1", "--device", "cpu",
                           "--content_train", str(pngs), "--weights_root", store, "-b", "2",
                           "--shorter_side", "72", "--max_steps", "1", "-p", "t"]) == 0
    (run,) = [d for d in os.listdir("Experiments") if d.endswith("_t")]
    log = [f for f in os.listdir(os.path.join("Experiments", run, "weights"))
           if f.startswith("log_")][0]
    assert "E1S0" in open(os.path.join("Experiments", run, "weights", log)).read()


def test_save_tree_npz_round_trips(tmp_path, rng):
    tree = {"conv11": {"w": torch.from_numpy(rng.random((3, 3, 3, 4), np.float32)),
                       "b": rng.random(4).astype(np.float32)}}
    path = str(tmp_path / "sub" / "e.npz")
    save_tree_npz(tree, path)
    back = load_tree_npz(path)
    np.testing.assert_array_equal(back["conv11"]["w"], tree["conv11"]["w"].numpy())
    np.testing.assert_array_equal(back["conv11"]["b"], tree["conv11"]["b"])
    with np.load(path) as z:
        assert sorted(z.files) == ["conv11/b", "conv11/w"]
