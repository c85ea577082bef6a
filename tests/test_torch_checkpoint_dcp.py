"""``save_checkpoint_dcp`` and ``load_checkpoint_dcp``, the PyTorch port's
counterpart of the reference's orbax backend, on the CPU:

* the tree of ``tests/test_train.py::test_orbax_checkpoint_roundtrip``
  (and one with every leaf kind the ``.npz`` backend takes) round-trips bit
  for bit, to what ``load_checkpoint`` returns for the same tree;
* a port ``Trainer``'s state (params, Adam state, meta) round-trips bit for
  bit, and one step resumed from the DCP checkpoint and from the ``.npz``
  one gives bit-equal masters;
* two processes over gloo, each a data-parallel trainer with identical
  replicas (``tests/torch_dcp_worker.py``), save one checkpoint
  collectively and each load it back whole; the single process reads the
  same directory to the same tree.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
from collaborative_distillation_tpu_torch.models.vgg import init_params
from collaborative_distillation_tpu_torch.train.trainer import TrainConfig, Trainer
from collaborative_distillation_tpu_torch.utils.checkpoint import (_flatten, load_checkpoint,
                                                                   load_checkpoint_dcp,
                                                                   save_checkpoint,
                                                                   save_checkpoint_dcp)

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_bit_equal(got, want):
    fg, fw = _flatten(got), _flatten(want)
    assert sorted(fg) == sorted(fw)
    for k, w in fw.items():
        g = fg[k]
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), k


def test_reference_orbax_tree_round_trips(tmp_path):
    tree = {"params": {"conv": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                                "b": np.ones(4, np.float32)}},
            "step": np.int32(7)}
    path = str(tmp_path / "ockpt")
    save_checkpoint_dcp(path, tree)
    out = load_checkpoint_dcp(path, tree)
    np.testing.assert_array_equal(out["params"]["conv"]["w"], tree["params"]["conv"]["w"])
    assert int(out["step"]) == 7 and out["step"].dtype == np.int32
    _assert_bit_equal(out, tree)


def test_every_leaf_kind_matches_the_npz_backend(tmp_path, rng):
    tree = {"a": rng.standard_normal((2, 3)).astype(np.float32),
            "t": torch.arange(5, dtype=torch.int64), "f64": rng.standard_normal(4),
            "s": (np.int32(3), [True, 2.5, 7]), "none": None, "empty": (),
            "meta": {"mode": "wct_se", "name": "ünïcode", "stage": 5},
            "json": {"cfg": [1, "two"]}, "zero": np.zeros((0, 3), np.float32)}
    save_checkpoint_dcp(str(tmp_path / "d"), tree)
    save_checkpoint(str(tmp_path / "n"), tree)
    got = load_checkpoint_dcp(str(tmp_path / "d"), tree)
    want = load_checkpoint(str(tmp_path / "n"), tree)
    _assert_bit_equal(got, want)
    assert got["none"] is None and got["empty"] == () and str(got["meta"]["name"]) == "ünïcode"
    # a second save replaces the first whole
    save_checkpoint_dcp(str(tmp_path / "d"), {"a": np.ones(2, np.float32)})
    two = {"a": np.zeros(2, np.float32)}
    assert load_checkpoint_dcp(str(tmp_path / "d"), two)["a"].tolist() == [1.0, 1.0]
    with pytest.raises(KeyError):
        load_checkpoint_dcp(str(tmp_path / "d"), {**two, "t": tree["t"]})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint_dcp(str(tmp_path / "d"), {"a": np.ones(3, np.float32)})


def _setup():
    gen = torch.Generator().manual_seed(3)
    frozen = {"be": init_params(encoder_spec("original", 1), gen),
              "bd": init_params(decoder_spec("original", 1), gen)}
    student = init_params(encoder_spec("16x", 1, aux=True), gen)
    np_tree = lambda t: {n: {k: v.numpy() for k, v in leaf.items()} for n, leaf in t.items()}
    return np_tree(student), {f: np_tree(t) for f, t in frozen.items()}


def _trainer(student, frozen, **cfg):
    return Trainer(TrainConfig(mode="wct_se", stage=1, lr=1e-3, **cfg), student, frozen,
                   device="cpu")


@pytest.mark.parametrize("lr_decay", [0, 10])
def test_trainer_state_round_trips_and_resumes_alike(tmp_path, rng, lr_decay):
    student, frozen = _setup()
    batches = [rng.random((2, 32, 32, 3), dtype=np.float32) for _ in range(3)]
    tr = _trainer(student, frozen, lr_final=1e-5 if lr_decay else 0.0, lr_decay_steps=lr_decay)
    for b in batches[:2]:
        tr.train_step(b)
    state = tr.state(epoch=2, step=2)
    save_checkpoint_dcp(str(tmp_path / "dcp"), state)
    tr.save(str(tmp_path / "ckpt"), epoch=2, step=2)
    masters = []
    for load in ("dcp", "npz"):
        fresh = _trainer(student, frozen, lr_final=1e-5 if lr_decay else 0.0,
                         lr_decay_steps=lr_decay)
        if load == "dcp":
            meta = fresh.load_state(load_checkpoint_dcp(str(tmp_path / "dcp"), fresh.state()))
        else:
            meta = fresh.restore(str(tmp_path / "ckpt"))
        assert int(meta["epoch"]) == 2 and str(meta["mode"]) == "wct_se"
        _assert_bit_equal({k: v for k, v in fresh.state().items() if k != "meta"},
                          {k: v for k, v in state.items() if k != "meta"})
        fresh.train_step(batches[2])
        masters.append(_flatten(fresh.params))
    assert sorted(masters[0]) == sorted(masters[1])
    for k in masters[0]:
        assert masters[0][k].tobytes() == masters[1][k].tobytes(), k


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_save_one_checkpoint_collectively(tmp_path, rng):
    student, frozen = _setup()
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, batch=rng.random((4, 32, 32, 3), dtype=np.float32),
             **{f"student/{n}/{k}": a for n, leaf in student.items() for k, a in leaf.items()},
             **{f"frozen/{f}/{n}/{k}": a for f, tree in frozen.items()
                for n, leaf in tree.items() for k, a in leaf.items()})
    ckpt = str(tmp_path / "dcp")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.dirname(HERE), HERE]),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dcp_worker.py"),
                               f"127.0.0.1:{port}", "2", str(r), inputs, ckpt,
                               str(tmp_path / f"out{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    keys = [k[len("saved/"):] for k in outs[0] if k.startswith("saved/params/")
            or k.startswith("saved/opt_state/")]
    assert len(keys) > 2 * len(student)
    tr = _trainer(student, frozen)
    here = _flatten(load_checkpoint_dcp(ckpt, tr.state(epoch=1, step=1)))
    for out in outs:
        assert int(out["epoch"]) == 1
        for k in keys:
            assert out[f"loaded/{k}"].tobytes() == out[f"saved/{k}"].tobytes(), k
            assert out[f"saved/{k}"].tobytes() == outs[0][f"saved/{k}"].tobytes(), k
            assert here[k].tobytes() == out[f"saved/{k}"].tobytes(), k
    # each tensor was written once: the two ranks' data files hold what one
    # process writes of the same tree, not twice that
    one = str(tmp_path / "one")
    save_checkpoint_dcp(one, load_checkpoint_dcp(ckpt, tr.state(epoch=1, step=1)))

    def data_bytes(d):
        return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
                   if f.endswith(".distcp"))

    assert data_bytes(ckpt) < 1.2 * data_bytes(one)
