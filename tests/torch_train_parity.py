"""Shared set-up of the training parity tests (``test_torch_train_*.py``):
the reference's student and frozen params drawn as its own tests draw them,
each package's losses and student gradients on the same inputs, and the
comparisons with their tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from collaborative_distillation_tpu.models import decoder_spec, encoder_spec, init_params
from collaborative_distillation_tpu.train.trainer import TrainConfig as JConfig
from collaborative_distillation_tpu.train.trainer import make_loss_fn as j_make_loss_fn
from collaborative_distillation_tpu_torch.train.trainer import TrainConfig, make_loss_fn
from collaborative_distillation_tpu_torch.utils.params import params_from_jax

MODES = ["wct_se", "wct_sd", "wct_sd_kd2sd"]


def jax_setup(mode, k):
    """Student and frozen params as the reference's tests draw them."""
    ks = jax.random.split(jax.random.key(0), 8)
    be = init_params(encoder_spec("original", k), ks[0])
    bd = init_params(decoder_spec("original", k), ks[1])
    se = init_params(encoder_spec("16x", k, aux=True), ks[2])
    if mode == "wct_se":
        return se, {"be": be, "bd": bd}
    if mode == "wct_sd":
        return init_params(decoder_spec("16x", k), ks[3]), {"be": be, "se": se}
    return init_params(decoder_spec("16x", k, aux=True), ks[4]), {"be": be, "bd": bd, "se": se}


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def port_tree(tree, dtype=torch.float32, grad=False):
    return {name: {kind: t.to(dtype).requires_grad_(grad) for kind, t in leaf.items()}
            for name, leaf in params_from_jax(to_np(tree)).items()}


def jax_losses_and_grads(mode, k, student, frozen, batch, **cfg):
    fn, weights = j_make_loss_fn(JConfig(mode=mode, stage=k, **cfg))

    def total(p):
        losses, _ = fn(p, frozen, jnp.asarray(batch))
        return sum(weights[n] * v for n, v in losses.items()), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(student)
    return {n: float(v) for n, v in losses.items()}, to_np(grads)


def port_losses_and_grads(mode, k, student, frozen, batch, dtype=torch.float32, **cfg):
    fn, weights = make_loss_fn(TrainConfig(mode=mode, stage=k, **cfg))
    p = port_tree(student, dtype, grad=True)
    f = {name: port_tree(tree, dtype) for name, tree in frozen.items()}
    losses, rec = fn(p, f, torch.from_numpy(batch).to(dtype))
    sum(weights[n] * v for n, v in losses.items()).backward()
    for tree in f.values():
        assert all(t.grad is None for leaf in tree.values() for t in leaf.values())
    return ({n: float(v.detach()) for n, v in losses.items()},
            {n: {kind: t.grad for kind, t in leaf.items()} for n, leaf in p.items()}, rec)


def assert_grads_close(got, want, rel=1e-4):
    for name, leaf in want.items():
        for kind, g in leaf.items():
            g = np.asarray(g, np.float64)
            mine = got[name][kind]
            assert mine is not None, (name, kind)
            err = float(np.abs(mine.detach().double().numpy() - g).max())
            assert err <= rel * max(float(np.abs(g).max()), 1e-30), (name, kind, err)


def assert_losses_close(got, want, rel=1e-5):
    assert set(got) == set(want)
    for n in want:
        assert abs(got[n] - want[n]) <= rel * abs(want[n]), (n, got[n], want[n])
