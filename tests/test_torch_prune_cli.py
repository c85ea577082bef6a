"""The PyTorch port's ``cli.prune`` against the reference's, on the CPU.

For each stage 1-5 and each kind, both CLIs on the same teacher npz (seeded
numpy weights at the teachers' widths) write bit-equal pruned layers and
aux adapters of equal shapes (the port draws its adapters from a seeded
``torch.Generator``, the reference from ``jax.random``); the port's file
loads through ``load_stage_params``. The stage-2 students' CPU forwards,
aux adapters left out, match the reference's forwards of the
reference-pruned students within 1e-5 of each map's largest magnitude.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from collaborative_distillation_tpu.cli import prune as jax_prune
from collaborative_distillation_tpu.models import vgg as jvgg
from collaborative_distillation_tpu.models import zoo as jzoo
from collaborative_distillation_tpu.models.specs import decoder_spec as j_decoder_spec
from collaborative_distillation_tpu.models.specs import encoder_spec as j_encoder_spec

import torch

from collaborative_distillation_tpu_torch.cli import prune
from collaborative_distillation_tpu_torch.models import vgg as tvgg
from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
from collaborative_distillation_tpu_torch.models.zoo import (load_stage_params, load_tree_npz,
                                                             save_tree_npz)

KINDS = {"encoder": (lambda k: encoder_spec("original", k),
                     lambda k: encoder_spec("16x", k, aux=True)),
         "decoder": (lambda k: decoder_spec("original", k), lambda k: decoder_spec("16x", k))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _teacher(tmp_path, kind, k, seed):
    rng = np.random.default_rng(seed)
    spec = KINDS[kind][0](k)
    tree = {n: {"w": rng.standard_normal(ws, np.float32) * 0.1,
                "b": rng.standard_normal(bs, np.float32) * 0.1}
            for n, (ws, bs) in spec.param_shapes().items()}
    path = str(tmp_path / f"{kind}{k}.npz")
    save_tree_npz(tree, path)
    return path


def _prune_both(tmp_path, kind, k, seed):
    teacher = _teacher(tmp_path, kind, k, seed)
    out = {}
    for mod, tag in ((prune, "port"), (jax_prune, "jax")):
        path = str(tmp_path / f"{tag}_{kind}{k}.npz")
        assert mod.main(["--teacher", teacher, "--kind", kind, "--stage", str(k),
                         "--output", path]) == 0
        out[tag] = path
    return out


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_prune_cli_bit_equal_to_the_reference(tmp_path, capsys, kind, k):
    paths = _prune_both(tmp_path, kind, k, seed=10 * k + len(kind))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split("(")[1] == lines[1].split("(")[1]   # layer and param counts
    got, want = load_tree_npz(paths["port"]), load_tree_npz(paths["jax"])
    s_spec = KINDS[kind][1](k)
    assert sorted(got) == sorted(want) == sorted(s_spec.param_shapes())
    aux = {l.name for l in s_spec.aux}
    assert (kind == "encoder") == bool(aux)
    for name in want:
        for leaf in ("w", "b"):
            g, w = got[name][leaf], want[name][leaf]
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, (name, leaf)
            if name not in aux:
                assert g.tobytes() == w.tobytes(), (name, leaf)
    params = load_stage_params(paths["port"], s_spec)
    assert all(params[n]["w"].shape == ws for n, (ws, _) in s_spec.param_shapes().items())
    # the adapters: torch.Generator draws, not zeros (a seed moves them)
    if aux:
        again = str(tmp_path / "seed1.npz")
        prune.main(["--teacher", str(tmp_path / f"{kind}{k}.npz"), "--kind", kind,
                    "--stage", str(k), "--output", again, "--aux_seed", "1"])
        other = load_tree_npz(again)
        for name in aux:
            assert np.abs(got[name]["w"]).max() > 0
            assert not np.array_equal(other[name]["w"], got[name]["w"])


def test_pruned_stage2_forward_matches_the_reference(tmp_path, capsys, rng):
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    for kind in ("encoder", "decoder"):
        paths = _prune_both(tmp_path, kind, 2, seed=7)
        spec, jspec = KINDS[kind][1](2), (j_encoder_spec("16x", 2, aux=True) if kind == "encoder"
                                          else j_decoder_spec("16x", 2))
        tp = load_stage_params(paths["port"], spec)
        jp = jzoo.load_stage_params(paths["jax"], jspec)
        if kind == "encoder":
            want = jvgg.apply_encoder(jp, jnp.asarray(x), jspec)
            got = tvgg.apply_encoder(tp, torch.from_numpy(x), spec, aux=False)
            want = {key: v for key, v in want.items() if not key.startswith("aux")}
        else:
            feat = rng.random((2, 16, 16, spec.layers[0].in_ch), dtype=np.float32)
            want = jvgg.apply_decoder(jp, jnp.asarray(feat), jspec)
            got = tvgg.apply_decoder(tp, torch.from_numpy(feat), spec)
        assert set(got) == set(want) and "out" in got
        for key, w in want.items():
            w = np.asarray(w)
            g = got[key].numpy()
            assert g.shape == w.shape, (kind, key)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{kind} {key}")
    capsys.readouterr()
