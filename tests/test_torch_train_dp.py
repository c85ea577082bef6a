"""The PyTorch port's data-parallel trainer on the CPU: ``Trainer(mesh=)``
with four replicas on ``devices=["cpu"] * 4`` against the port's
single-device trainer and the reference's ``Trainer(mesh=make_mesh(data=4))``
(8 virtual CPU devices), in float32 and bfloat16; checkpoints across
single-device, data-parallel and reference trainers; the refusals; and two
processes over gloo joined by ``initialize_multihost``."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from collaborative_distillation_tpu.parallel.mesh import make_mesh as j_make_mesh
from collaborative_distillation_tpu.train.trainer import TrainConfig as JConfig
from collaborative_distillation_tpu.train.trainer import Trainer as JTrainer

import torch

from collaborative_distillation_tpu_torch.parallel.mesh import make_mesh
from collaborative_distillation_tpu_torch.train.trainer import TrainConfig, Trainer
from torch_train_parity import assert_losses_close, jax_setup, to_np

STAGE = 2
LR = 1e-3
DP = 4
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


def _batches(rng, n=3, size=DP):
    return [rng.random((size, 32, 32, 3), dtype=np.float32) for _ in range(n)]


def _cfg(mode, **kw):
    return dict(mode=mode, stage=STAGE, **kw)


def _port(mode, mesh=None, **kw):
    student, frozen = jax_setup(mode, STAGE)
    return Trainer(TrainConfig(**_cfg(mode, **kw)), to_np(student), to_np(frozen),
                   device="cpu", mesh=mesh)


def _dp(mode, **kw):
    return _port(mode, mesh=make_mesh(data=DP, devices=["cpu"] * DP), **kw)


def _leaves(params):
    return [(name, kind, t) for name, leaf in params.items() for kind, t in leaf.items()]


def _snapshot(params):
    return {name: {kind: t.detach().numpy().copy() for kind, t in leaf.items()}
            for name, leaf in params.items()}


def _losses(losses):
    return {k: float(v) for k, v in losses.items()}


def _whole_batch_grads(single, params, batch):
    """The single-device trainer's gradient of the whole batch's loss at
    ``params`` (the data-parallel trainer's masters before its step), in
    its compute dtype: what the replicas' mean must equal."""
    from collaborative_distillation_tpu_torch.train.trainer import _cast
    p = {n: {k: t.detach().clone().requires_grad_() for k, t in leaf.items()}
         for n, leaf in params.items()}
    with single._precision():
        losses, _ = single.loss_graph(_cast(p, single.dtype), single.frozen,
                                      torch.from_numpy(batch).to(single.dtype))
        sum(single.loss_weights[k] * v for k, v in losses.items()).backward()
    return {n: {k: t.grad for k, t in leaf.items()} for n, leaf in p.items()}


def _assert_grads_close(dp, want, rel):
    """The root's ``.grad`` within ``rel`` of each leaf's max|g|; zero where
    the whole batch's loss does not reach the leaf."""
    for name, kind, t in _leaves(dp.params):
        if want[name][kind] is None:
            assert not t.grad.any(), (name, kind)
            continue
        g = want[name][kind].double()
        err = float((t.grad.double() - g).abs().max())
        assert err <= rel * float(g.abs().max()), (name, kind, err)


def _assert_replicas_equal_root(dp):
    root = _leaves(dp.params)
    assert len(dp.replicas) == DP
    for replica in dp.replicas[1:]:
        for (name, kind, t), (_, _, r) in zip(_leaves(replica.params()), root):
            assert t is not r and torch.equal(t, r), (name, kind)


def _assert_updates_close(t0, t1, j0, j1, rel=1e-3):
    """Each leaf's update within ``rel`` of the other's norm (as
    tests/test_torch_train_trainer.py holds the port to the reference)."""
    for name, leaf in j1.items():
        for kind, a in leaf.items():
            want = (a - j0[name][kind]).astype(np.float64)
            got = (t1[name][kind] - t0[name][kind]).astype(np.float64)
            assert np.linalg.norm(want) > 0, (name, kind)
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= rel, (name, kind, err)


def _assert_params_close(params, want, atol):
    for name, kind, t in _leaves(params):
        err = float(np.abs(t.detach().numpy() - np.asarray(want[name][kind])).max())
        assert err <= atol, (name, kind, err)


def test_dp_matches_single_device_and_reference_f32(rng):
    """wct_se, batch 4 over 4 replicas, 3 steps. Each step: losses within
    1e-6 relative of the port's single-device trainer and 1e-4 of the
    reference's data-parallel one; the root's mean gradient within 1e-5 of
    each leaf's max|g| of the whole batch's gradient at the same masters;
    every replica's masters bit-identical to the root's. After 3 steps each
    leaf's update within 1e-3 of its norm of both trainers' (Adam's first
    steps are near lr * sign(g), so a component with a gradient near 0 may
    step either way: the update is held as a whole)."""
    jt = JTrainer(JConfig(**_cfg("wct_se", lr=LR)), *jax_setup("wct_se", STAGE),
                  mesh=j_make_mesh(data=DP))
    single, dp = _port("wct_se", lr=LR), _dp("wct_se", lr=LR)
    j0, s0, d0 = to_np(jt.params), _snapshot(single.params), _snapshot(dp.params)
    for batch in _batches(rng):
        want = _whole_batch_grads(single, dp.params, batch)
        jl, _ = jt.train_step(batch)
        sl, srec = single.train_step(batch)
        dl, drec = dp.train_step(batch)
        assert_losses_close(_losses(dl), _losses(sl), rel=1e-6)
        assert_losses_close(_losses(dl), _losses(jl), rel=1e-4)
        assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in dl.values())
        assert drec.shape == (DP, 32, 32, 3) and drec.dtype == torch.float32
        assert float((drec - srec).abs().max()) <= 1e-5
        _assert_grads_close(dp, want, 1e-5)
        _assert_replicas_equal_root(dp)
    d1 = _snapshot(dp.params)
    _assert_updates_close(d0, d1, s0, _snapshot(single.params))
    _assert_updates_close(d0, d1, j0, to_np(jt.params))


def test_dp_matches_single_device_and_reference_bf16(rng):
    """The same in bfloat16 at the reference's own data-parallel tolerances
    (tests/test_train.py: losses rtol 2e-2, params atol 5e-4, at its lr
    1e-4), against the port's single-device trainer and the reference's
    data-parallel one; the root's mean gradient against the whole batch's
    bf16 gradient at the same masters within 2^-4 of each leaf's max|g|
    (bf16 rounds each shard's sums on its own, 2^-8 relative each: the card's
    8e(b) tolerance); replicas bit-identical; masters float32."""
    jt = JTrainer(JConfig(**_cfg("wct_se", compute_dtype="bfloat16")),
                  *jax_setup("wct_se", STAGE), mesh=j_make_mesh(data=DP))
    single = _port("wct_se", compute_dtype="bfloat16")
    dp = _dp("wct_se", compute_dtype="bfloat16")
    for batch in _batches(rng):
        want = _whole_batch_grads(single, dp.params, batch)
        jl, _ = jt.train_step(batch)
        sl, _ = single.train_step(batch)
        dl, drec = dp.train_step(batch)
        for ref in (sl, jl):
            for name, v in _losses(ref).items():
                np.testing.assert_allclose(float(dl[name]), v, rtol=2e-2)
        assert drec.dtype == torch.float32
        _assert_grads_close(dp, want, 2 ** -4)
        _assert_replicas_equal_root(dp)
        assert all(t.dtype == torch.float32 for _, _, t in _leaves(dp.params))
    _assert_params_close(dp.params, _snapshot(single.params), 5e-4)
    _assert_params_close(dp.params, to_np(jt.params), 5e-4)


@pytest.mark.parametrize("mode,weights", [("wct_sd", {}), ("wct_sd_kd2sd", {}),
                                          ("wct_se", {"lw_feat": 0})],
                         ids=["wct_sd", "wct_sd_kd2sd", "wct_se-lw_feat0"])
def test_dp_other_modes_one_step(rng, mode, weights):
    """One step of each other mode against the port's single-device step:
    losses 1e-6 relative, the mean gradient 1e-5 of each leaf's max|g|,
    replicas bit-identical; uint8 batches normalized on each replica's
    device as on one. With ``lw_feat`` 0 the feature loss is not taken and
    the aux adapter it alone reaches gets no gradient: its mean is zero and
    it stays where the single-device step leaves it."""
    single, dp = _port(mode, lr=LR, **weights), _dp(mode, lr=LR, **weights)
    (batch,) = _batches(rng, 1)
    u8 = (batch * 255).astype(np.uint8)
    want = _whole_batch_grads(single, dp.params, u8.astype(np.float32) / 255.0)
    sl, _ = single.train_step(u8)
    dl, _ = dp.train_step(u8)
    assert_losses_close(_losses(dl), _losses(sl), rel=1e-6)
    _assert_grads_close(dp, want, 1e-5)
    _assert_replicas_equal_root(dp)
    for name, kind, t in _leaves(dp.params):
        if want[name][kind] is None:
            assert torch.equal(t, single.params[name][kind]), (name, kind)


def test_dp_checkpoints_resume_everywhere(rng, tmp_path):
    """A data-parallel checkpoint resumes in the port's single-device
    trainer and in the reference's trainer; the single-device port's and the
    reference's resume in a data-parallel trainer, into every replica. The
    next step's losses agree within 1e-5 relative (1e-6 between the port's
    trainers)."""
    mode = "wct_sd_kd2sd"
    sched = {"lr_final": 1e-4, "lr_decay_steps": 5, "lr": LR}
    b1, b2 = _batches(rng, 2)
    dp, single = _dp(mode, **sched), _port(mode, **sched)
    jt = JTrainer(JConfig(**_cfg(mode, **sched)), *jax_setup(mode, STAGE))
    for t in (dp, single, jt):
        t.train_step(b1)
    paths = {k: str(tmp_path / k) for k in ("dp", "single", "jax")}
    dp.save(paths["dp"], epoch=2, step=9)
    single.save(paths["single"], epoch=2, step=9)
    jt.save(paths["jax"], epoch=2, step=9)
    with np.load(paths["dp"] + ".npz") as a, np.load(paths["single"] + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
    # the data-parallel checkpoint, in a fresh single-device trainer
    one = _port(mode, **sched)
    assert int(one.restore(paths["dp"])["step"]) == 9 and one.sched_count == 1
    after_dp = _losses(dp.train_step(b2)[0])
    assert_losses_close(_losses(one.train_step(b2)[0]), after_dp, rel=1e-6)
    # the others', in fresh data-parallel trainers: every replica loaded
    for name, want, rel in (("single", lambda: _losses(single.train_step(b2)[0]), 1e-6),
                            ("jax", lambda: _losses(jt.train_step(b2)[0]), 1e-4)):
        again = _dp(mode, **sched)
        again.restore(paths[name])
        _assert_replicas_equal_root(again)
        with np.load(paths[name] + ".npz") as z:
            for layer, kind, t in _leaves(again.replicas[-1].params()):
                np.testing.assert_array_equal(t.detach().numpy(), z[f"params/{layer}/{kind}"])
        assert_losses_close(_losses(again.train_step(b2)[0]), want(), rel=rel)
    # and the data-parallel checkpoint in the reference, after its own step
    jt.restore(paths["dp"])
    assert_losses_close(_losses(jt.train_step(b2)[0]), after_dp, rel=1e-4)


def test_dp_refusals(rng):
    """A batch that does not divide over the replicas is refused with the
    reference CLI's words; so is a mesh with a 'space' axis; a mesh of
    CUDA devices without CUDA raises."""
    dp = _dp("wct_sd")
    with pytest.raises(ValueError, match="batch_size 3 not divisible by 4 devices"):
        dp.train_step(rng.random((3, 32, 32, 3), dtype=np.float32))
    with pytest.raises(ValueError, match="'space'"):
        _port("wct_sd", mesh=make_mesh(data=2, space=2, devices=["cpu"] * 4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _port("wct_sd", mesh=make_mesh(data=2, devices=["cuda:0"] * 2))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_over_gloo_match_single_device(rng, tmp_path):
    """Two processes (``tests/torch_dp_worker.py``), each with two replicas
    on ``["cpu"] * 2``, joined by ``initialize_multihost`` over gloo on
    127.0.0.1, take one wct_se step on a global batch of 4, each handed
    its two rows: each process's losses within 1e-6 relative and its mean
    gradient within 1e-5 of each leaf's max|g| of the single-device step,
    ``rec`` the whole batch's, and both processes' masters bit-identical."""
    mode = "wct_se"
    student, frozen = jax_setup(mode, STAGE)
    (batch,) = _batches(rng, 1)
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, batch=batch,
             **{f"student/{n}/{k}": a for n, leaf in to_np(student).items()
                for k, a in leaf.items()},
             **{f"frozen/{f}/{n}/{k}": a for f, tree in to_np(frozen).items()
                for n, leaf in tree.items() for k, a in leaf.items()})
    single = _port(mode, lr=LR)
    want = _whole_batch_grads(single, single.params, batch)
    sl, srec = single.train_step(batch)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.path.dirname(HERE), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dp_worker.py"),
                               f"127.0.0.1:{port}", "2", str(r), inputs,
                               str(tmp_path / f"out{r}.npz"), mode, str(LR)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    for out in outs:
        assert bool(out["replicas_equal"])
        assert_losses_close({k[5:]: float(v) for k, v in out.items() if k.startswith("loss/")},
                            _losses(sl), rel=1e-6)
        np.testing.assert_allclose(out["rec"], srec.numpy(), rtol=0, atol=1e-5)
        for name, kind, t in _leaves(single.params):
            g = want[name][kind].numpy()
            err = float(np.abs(out[f"grad/{name}/{kind}"] - g).max())
            assert err <= 1e-5 * float(np.abs(g).max()), (name, kind, err)
    masters = [k for k in outs[0] if k.startswith("params/")]
    assert len(masters) == 2 * len(single.params)
    for k in masters:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
