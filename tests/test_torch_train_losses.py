"""Training gradients of the PyTorch port against the reference package, on
the CPU: the autograd Functions around the kernels' plain versions, and the
three loss graphs at stage 2 (the SE's at stage 5, teacher widths, is in
``test_torch_train_teacher_widths.py``).

Tolerances: losses within 1e-5 relative (float32 sums of a few thousand
terms in another order); student gradients within 1e-4 of each leaf's
max|g|. Subgradients at kinks (ReLU at exactly 0, tied pool windows) are
held exactly where the op is tested alone.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from collaborative_distillation_tpu.models import decoder_spec
from collaborative_distillation_tpu.ops import conv as jconv
from collaborative_distillation_tpu_torch.ops import conv as tconv
from torch_train_parity import (MODES, assert_grads_close, assert_losses_close,
                                jax_losses_and_grads, jax_setup, port_losses_and_grads)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the Functions alone -------------------------------------------------------

def _cotangent(shape):
    """Whole numbers in [-3, 3]: the same float32 values in both frameworks."""
    return (np.arange(int(np.prod(shape))) % 7 - 3).astype(np.float32).reshape(shape)


def _grads(fn, *args):
    args = [a.detach().requires_grad_() for a in args]
    y = fn(*args)
    y.backward(torch.from_numpy(_cotangent(tuple(y.shape))))
    return [a.grad for a in args]


def _jgrads(fn, *args, absolute=False):
    y = fn(*args)
    g = jnp.asarray(_cotangent(y.shape))
    return jax.vjp(fn, *args)[1](jnp.abs(g) if absolute else g)


@pytest.mark.parametrize("shape", [(2, 7, 9, 5, 6), (1, 1, 1, 4, 3), (1, 2, 5, 3, 8),
                                   (2, 6, 6, 16, 4)], ids=str)
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_function_gradients_match_jax(rng, shape, relu):
    n, h, w, ci, co = shape
    x = rng.standard_normal((n, h, w, ci)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci)).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    got = _grads(lambda a, c, d: tconv.conv3x3(a, c, d, relu=relu),
                 *(torch.from_numpy(t) for t in (x, wt, b)))
    want = _jgrads(lambda a, c, d: jconv.conv3x3(a, c, d, relu=relu),
                   *(jnp.asarray(t) for t in (x, wt, b)))
    # each gradient is a sum of products in another order: held to 1e-5 of
    # the largest magnitude a partial sum can take (the same sums of |terms|)
    scale = _jgrads(lambda a, c, d: jconv.conv3x3(a, c, d, relu=False),
                    *(jnp.abs(jnp.asarray(t)) for t in (x, wt, b)), absolute=True)
    for g, j, s in zip(got, want, scale):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-5 * float(np.abs(np.asarray(s)).max()))


def test_relu_at_zero_passes_half_the_gradient():
    # zero weights and bias: every pre-activation is exactly 0
    x = torch.rand(1, 4, 5, 3)
    w = torch.zeros(3, 3, 3, 2, requires_grad=True)
    b = torch.zeros(2, requires_grad=True)
    g = torch.rand(1, 4, 5, 2)
    tconv.conv3x3(x, w, b, relu=True).backward(g)
    jb = jax.grad(lambda bb: jnp.sum(jconv.conv3x3(jnp.asarray(x.numpy()), jnp.zeros((3, 3, 3, 2)),
                                                   bb, relu=True) * g.numpy()))(jnp.zeros(2))
    assert torch.equal(b.grad, 0.5 * g.sum(dim=(0, 1, 2)))
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jb), rtol=1e-6)
    y = torch.tensor([[-1.0, 0.0, 2.0]], requires_grad=True)
    tconv.conv1x1(y, torch.eye(3).reshape(1, 1, 3, 3), None, relu=True).sum().backward()
    assert y.grad.tolist() == [[0.0, 0.5, 1.0]]


@pytest.mark.parametrize("window,first", [([1, 1, 1, 1], 0), ([0, 1, 1, 0], 1),
                                          ([0, 0, 1, 1], 2), ([2, 3, 1, 3], 1)])
def test_pool_ties_give_the_first_maximum(window, first):
    x = torch.tensor(window, dtype=torch.float32).reshape(1, 2, 2, 1).requires_grad_()
    tconv.max_pool_2x2(x).sum().backward()
    want = np.zeros(4, np.float32)
    want[first] = 1.0
    jg = jax.grad(lambda a: jconv.max_pool_2x2(a).sum())(jnp.asarray(x.detach().numpy()))
    assert x.grad.reshape(-1).tolist() == want.tolist() == np.asarray(jg).reshape(-1).tolist()


@pytest.mark.parametrize("shape", [(2, 6, 8, 3), (1, 7, 9, 4), (1, 1, 3, 2), (1, 5, 5, 1)],
                         ids=str)
def test_pool_and_upsample_gradients_equal_jax(rng, shape):
    # whole-number values: many ties, and the sums are exact
    x = rng.integers(0, 3, shape).astype(np.float32)
    for t_op, j_op in ((tconv.max_pool_2x2, jconv.max_pool_2x2),
                       (tconv.upsample_nearest_2x, jconv.upsample_nearest_2x)):
        (got,) = _grads(t_op, torch.from_numpy(x))
        (want,) = _jgrads(j_op, jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the forward without grad is unchanged, bit for bit
    xt = torch.from_numpy(x)
    with torch.no_grad():
        plain = tconv.max_pool_2x2(xt)
    assert torch.equal(plain, tconv.max_pool_2x2(xt.clone().requires_grad_()).detach())


# ---- the loss graphs ---------------------------------------------------------------

def _batch(rng, n=2, hw=32):
    return rng.random((n, hw, hw, 3), dtype=np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_loss_graph_matches_jax_at_stage2(rng, mode):
    student, frozen = jax_setup(mode, 2)
    batch = _batch(rng)
    jl, jg = jax_losses_and_grads(mode, 2, student, frozen, batch)
    tl, tg, rec = port_losses_and_grads(mode, 2, student, frozen, batch)
    assert rec.shape == (2, 32, 32, 3)
    assert_losses_close(tl, jl)
    assert_grads_close(tg, jg)


def test_zero_aux_with_relu_trains_as_in_jax(rng):
    """The SD's aux adapters zero-filled, as the shipped 16x_base decoders
    load, with --updim_relu: every adapter output is exactly 0, and JAX's
    0.5 subgradient is all that trains them."""
    student, frozen = jax_setup("wct_sd_kd2sd", 2)
    aux = [layer.name for layer in decoder_spec("16x", 2, aux=True).aux]
    student = dict(student)
    for name in aux:
        student[name] = jax.tree.map(jnp.zeros_like, student[name])
    batch = _batch(rng)
    jl, jg = jax_losses_and_grads("wct_sd_kd2sd", 2, student, frozen, batch, aux_relu=True)
    tl, tg, _ = port_losses_and_grads("wct_sd_kd2sd", 2, student, frozen, batch,
                                      aux_relu=True)
    assert_losses_close(tl, jl)
    assert_grads_close(tg, jg)
    assert aux and all(float(tg[n]["w"].abs().max()) > 0 for n in aux)


def test_tied_pool_windows_train_as_in_jax(rng):
    """A constant block in the content: the BE's maps are constant over it,
    so its pool windows tie and the perceptual gradient goes to each
    window's first maximum."""
    student, frozen = jax_setup("wct_sd", 2)
    batch = _batch(rng)
    batch[:, 4:20, 6:22] = 0.5
    jl, jg = jax_losses_and_grads("wct_sd", 2, student, frozen, batch)
    tl, tg, _ = port_losses_and_grads("wct_sd", 2, student, frozen, batch)
    assert_losses_close(tl, jl)
    assert_grads_close(tg, jg)
