"""The PyTorch port's trainer, checkpoints and pruning against the reference
package, on the CPU: optimizer steps at constant and cosine lr, checkpoints
resumed across the two packages both ways, L1 pruning, and the trainer's
compute dtypes and refusals."""

import numpy as np
import pytest

import jax

import torch

from collaborative_distillation_tpu.models import decoder_spec as j_decoder_spec
from collaborative_distillation_tpu.models import encoder_spec as j_encoder_spec
from collaborative_distillation_tpu.models import init_params as j_init_params
from collaborative_distillation_tpu.train import prune as jprune
from collaborative_distillation_tpu.train.trainer import TrainConfig as JConfig
from collaborative_distillation_tpu.train.trainer import Trainer as JTrainer
from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
from collaborative_distillation_tpu_torch.train import prune as tprune
from collaborative_distillation_tpu_torch.train.trainer import TrainConfig, Trainer
from torch_train_parity import assert_losses_close, jax_setup, to_np

STAGE = 2
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(rng, n=3):
    return [rng.random((2, 32, 32, 3), dtype=np.float32) for _ in range(n)]


def _pair(mode, **cfg):
    student, frozen = jax_setup(mode, STAGE)
    jt = JTrainer(JConfig(mode=mode, stage=STAGE, lr=LR, **cfg), student, frozen)
    tt = Trainer(TrainConfig(mode=mode, stage=STAGE, lr=LR, **cfg), to_np(student),
                 to_np(frozen), device="cpu")
    return jt, tt


def _losses(losses):
    return {k: float(v) for k, v in losses.items()}


def _port_params(tt):
    return {name: {kind: t.detach().numpy().copy() for kind, t in leaf.items()}
            for name, leaf in tt.params.items()}


def _assert_params_close(tt, jparams, atol):
    for name, leaf in to_np(jparams).items():
        for kind, a in leaf.items():
            got = tt.params[name][kind].detach().numpy()
            assert float(np.abs(got - a).max()) <= atol, (name, kind)


def _assert_updates_close(t0, t1, j0, j1, rel=1e-3):
    """Each leaf's update p - p0 against the reference's: the norm of their
    difference within ``rel`` of the reference update's norm. A trainer that
    does not step, or steps the wrong way, is a whole update's norm off."""
    for name, leaf in j1.items():
        for kind, a in leaf.items():
            want = (a - j0[name][kind]).astype(np.float64)
            got = (t1[name][kind] - t0[name][kind]).astype(np.float64)
            assert np.linalg.norm(want) > 0, (name, kind)
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= rel, (name, kind, err)


@pytest.mark.parametrize("schedule", [{}, {"lr_final": 1e-4, "lr_decay_steps": 2}],
                         ids=["constant", "cosine"])
def test_three_steps_match_jax(rng, schedule):
    """Three steps on three batches, then the fourth step's losses within
    1e-4 relative. The params after three steps are held to 2 * lr * steps:
    Adam's first steps are close to lr * sign(g), so a component whose
    gradient is near 0 may step the other way in the two packages. That
    bound alone passes a trainer that never steps, so each leaf's update
    is also held to the reference's, as a whole (1e-3 of its norm; the two
    read at most 1.7e-4 apart). The cosine schedule (decay over 2 steps) is
    past its clamp at step 3."""
    jt, tt = _pair("wct_se", **schedule)
    j0, t0 = to_np(jt.params), _port_params(tt)
    for b in _batches(rng):
        jt.train_step(b)
        tt.train_step(b)
    _assert_params_close(tt, jt.params, 2 * LR * 3)
    _assert_updates_close(t0, _port_params(tt), j0, to_np(jt.params))
    last = rng.random((2, 32, 32, 3), dtype=np.float32)
    jl, _ = jt.train_step(last)
    tl, rec = tt.train_step(last)
    assert rec.shape == (2, 32, 32, 3) and not rec.requires_grad
    assert_losses_close(_losses(tl), _losses(jl), rel=1e-4)
    if schedule:
        assert tt.sched_count == 4 and tt.lr_at(3) == pytest.approx(1e-4, rel=1e-6)
    assert all(t.grad is None for tree in tt.frozen.values() for leaf in tree.values()
               for t in leaf.values())


def test_uint8_batch_is_normalized_on_the_device(rng):
    _, a = _pair("wct_sd")
    _, b = _pair("wct_sd")
    u8 = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    la, _ = a.train_step(u8)
    lb, _ = b.train_step(u8.astype(np.float32) / 255.0)
    assert _losses(la) == _losses(lb)


def _step_losses(trainer, batch):
    return _losses(trainer.train_step(batch)[0])


@pytest.mark.parametrize("schedule", [{}, {"lr_final": 1e-4, "lr_decay_steps": 5}],
                         ids=["constant", "cosine"])
def test_checkpoints_resume_across_packages(rng, tmp_path, schedule):
    """A reference checkpoint resumed by the port and a port checkpoint
    resumed by the reference: the next step's losses agree within 1e-5."""
    b1, b2 = _batches(rng, 2)
    jt, tt = _pair("wct_sd_kd2sd", **schedule)
    jt.train_step(b1)
    tt.train_step(b1)
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jt.save(jpath, epoch=3, step=17)
    tt.save(tpath, epoch=3, step=17)
    with np.load(jpath + ".npz") as a, np.load(tpath + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert ("opt_state/1/0" in b.files) == bool(schedule)
        assert all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape for k in a.files)
    jt2, tt2 = _pair("wct_sd_kd2sd", **schedule)
    meta = tt2.restore(jpath)        # the reference's checkpoint, in the port
    assert int(meta["epoch"]) == 3 and int(meta["step"]) == 17
    jt2.restore(tpath)               # the port's, in the reference
    assert_losses_close(_step_losses(tt2, b2), _step_losses(jt, b2))
    assert_losses_close(_losses(jt2.train_step(b2)[0]), _step_losses(tt, b2))


@pytest.mark.parametrize("kind,k", [("encoder", 3), ("decoder", 3), ("encoder", 5),
                                    ("decoder", 1)])
def test_prune_equals_reference(kind, k):
    jspec = (j_encoder_spec if kind == "encoder" else j_decoder_spec)
    tspec = (encoder_spec if kind == "encoder" else decoder_spec)
    teacher = to_np(j_init_params(jspec("original", k), jax.random.key(k)))
    student_j = jspec("16x", k, aux=True)
    student_t = tspec("16x", k, aux=True)
    aux = to_np(j_init_params(student_j, jax.random.key(7)))
    want = jprune.prune_to_student(teacher, student_j, init_aux=aux)
    got = tprune.prune_to_student(teacher, student_t, init_aux=aux)
    assert want.keys() == got.keys()
    for name in want:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(got[name][leaf], np.asarray(want[name][leaf]))
    zeros = tprune.prune_to_student(teacher, student_t)
    assert all(not zeros[layer.name]["w"].any() for layer in student_t.aux)
    w = np.asarray(teacher[student_t.layers[-1].name]["w"])
    for axis in ("out", "in"):
        np.testing.assert_array_equal(tprune.l1_keep_indices(w, 5, axis=axis),
                                      jprune.l1_keep_indices(w, 5, axis=axis))


def test_trainer_refusals():
    """bfloat16 builds a trainer (float32 masters, bf16 teachers); float16,
    which the port has no kernels for, raises naming ROADMAP."""
    student, frozen = jax_setup("wct_sd", 1)
    tr = Trainer(TrainConfig(mode="wct_sd", stage=1, compute_dtype="bfloat16"),
                 to_np(student), to_np(frozen), device="cpu")
    assert tr.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for leaf in tr.params.values() for t in leaf.values())
    assert all(t.dtype == torch.bfloat16 for f in tr.frozen.values() for leaf in f.values()
               for t in leaf.values())
    with pytest.raises(ValueError, match="ROADMAP"):
        Trainer(TrainConfig(mode="wct_sd", stage=1, compute_dtype="float16"),
                to_np(student), to_np(frozen), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(TrainConfig(mode="wct_sd", stage=1), to_np(student), to_np(frozen))
    with pytest.raises(ValueError, match="mode"):
        Trainer(TrainConfig(mode="wct", stage=1), to_np(student), to_np(frozen), device="cpu")
