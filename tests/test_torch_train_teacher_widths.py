"""The SE loss graph of the PyTorch port at stage 5 (teacher widths, Cin/Cout
to 512) against the reference package's, on the CPU: losses within 1e-5
relative, student gradients within 1e-4 of each leaf's max|g|."""

import numpy as np

import jax
import jax.numpy as jnp

import pytest
import torch

from collaborative_distillation_tpu_torch.ops.cuda import conv as kconv
from torch_train_parity import (assert_grads_close, assert_losses_close, jax_losses_and_grads,
                                jax_setup, port_losses_and_grads)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_se_loss_graph_matches_jax_at_stage5(rng):
    """Teacher widths to 512. The gradients are held with both packages in
    float64: in float32 one pre-activation of the random teacher decoder
    lies within rounding of 0 and takes the other side of the ReLU in one
    of the two computations (a kink that moves the deepest leaves'
    gradients past 1e-4 of their max), which float64 does not reach. The
    port's float32 losses are held to the reference's (whose mean squared
    errors are taken in float32 in both runs). The float32 gradients are
    held by the next test."""
    student, frozen = jax_setup("wct_se", 5)
    batch = rng.random((2, 32, 32, 3), dtype=np.float32)
    f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
    with jax.enable_x64(True):
        jl, jg = jax_losses_and_grads("wct_se", 5, f64(student), f64(frozen),
                                      batch.astype(np.float64))
    tl, _, rec = port_losses_and_grads("wct_se", 5, student, frozen, batch)
    assert rec.shape == (2, 32, 32, 3)
    assert_losses_close(tl, jl)
    _, tg, _ = port_losses_and_grads("wct_se", 5, student, frozen, batch.astype(np.float64),
                                     dtype=torch.float64)
    assert_grads_close(tg, jg)


def test_se_float32_grads_match_jax_at_stage5(rng, monkeypatch):
    """The port's float32 gradients at teacher widths against ``jax.grad``
    in float32, within 1e-4 of each leaf's max|g|, with the port's ReLU
    decisions held to its float64 run's: a float32 pre-activation whose
    sign differs from the float64 one takes the float64 value (the kink
    the test above names). At most two are held, each within 1e-6 of its
    conv's largest output, so a wrong conv or backward cannot hide as
    held decisions."""
    student, frozen = jax_setup("wct_se", 5)
    batch = rng.random((2, 32, 32, 3), dtype=np.float32)
    _, jg = jax_losses_and_grads("wct_se", 5, student, frozen, batch)
    plain, pres, held = kconv.conv3x3_plain, [], []

    def record(*args):
        pres.append(plain(*args))
        return pres[-1]

    monkeypatch.setattr(kconv, "conv3x3_plain", record)
    port_losses_and_grads("wct_se", 5, student, frozen, batch.astype(np.float64),
                          dtype=torch.float64)
    ref = iter(pres)

    def hold(*args):
        y, want = plain(*args), next(ref)
        flip = (y > 0) != (want > 0)
        if flip.any():
            held.extend((want[flip].abs() / want.abs().max()).tolist())
            y = torch.where(flip, want.to(y.dtype), y)
        return y

    monkeypatch.setattr(kconv, "conv3x3_plain", hold)
    _, tg, _ = port_losses_and_grads("wct_se", 5, student, frozen, batch)
    assert next(ref, None) is None
    assert len(held) <= 2 and all(r <= 1e-6 for r in held), held   # this seed: one, 1.4e-7
    assert_grads_close(tg, jg)
