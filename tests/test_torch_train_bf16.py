"""bfloat16 mixed-precision training of the PyTorch port against the
reference package, on the CPU: the bf16 ``Trainer`` (float32 masters and
Adam state, bf16 step) beside the reference's bf16 ``Trainer`` and a float64
run of the same step, bf16 checkpoints resumed across the two packages,
``ContentStylePairDataset``, and the autograd Functions' bf16 backward.

Tolerances (each stated where it is used):

* losses: the port's bf16 losses within ``BF16_LOSS_REL`` = 2^-6 relative
  of the reference's bf16 losses. Each is a float32 mean of maps whose
  elements carry a few bf16 roundings (2^-9 relative each); the two
  packages round in different places (the reference rounds a conv and then
  its bias, the port once), so they differ by a few roundings, not one.
* gradients: not elementwise against the reference (its XLA CPU bf16
  reductions round differently, and ReLU decisions near 0 flip between the
  two), but against float64: per student leaf, the relative L2 error of
  the port's bf16 gradient, ``|g - g64| / |g64|``, no larger than the
  reference's bf16 step's own, with a floor of twice the error that
  rounding the step's inputs alone to bf16 makes (a float64 step on the
  bf16-rounded masters, teachers and batch): no bf16 step can undo the
  rounding of its inputs, and its own roundings add about as much again.
"""

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

import torch
from torch.nn.grad import conv2d_input, conv2d_weight

from collaborative_distillation_tpu.data import pipeline as jpipe
from collaborative_distillation_tpu.train.trainer import TrainConfig as JConfig
from collaborative_distillation_tpu.train.trainer import Trainer as JTrainer
from collaborative_distillation_tpu_torch.data import ContentStylePairDataset
from collaborative_distillation_tpu_torch.ops import conv as tconv
from collaborative_distillation_tpu_torch.ops.cuda import conv as kconv
from collaborative_distillation_tpu_torch.ops.cuda import pool as kpool
from collaborative_distillation_tpu_torch.ops.pad import reflect_index, reflect_pad
from collaborative_distillation_tpu_torch.train.trainer import TrainConfig, Trainer
from torch_train_parity import (MODES, jax_losses_and_grads, jax_setup, port_losses_and_grads,
                                to_np)

BF16 = torch.bfloat16
BF16_LOSS_REL = 2.0 ** -6
ADAM_B1 = 0.9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rng, n=2, hw=32):
    return rng.random((n, hw, hw, 3), dtype=np.float32)


def _copy(tree):
    """An independent copy: the reference's jit'd step donates its params."""
    return jax.tree.map(jnp.copy, tree)


def _bf16_rounded(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                                             .astype(jnp.float32)), tree)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _assert_losses_close(got, want, rel=BF16_LOSS_REL):
    assert set(got) == set(want)
    for n in want:
        g, w = float(got[n]), float(want[n])
        assert np.isfinite(g) and abs(g - w) <= rel * abs(w), (n, g, w)


# ---- the step against the reference's bf16 Trainer and float64 ------------------

@pytest.mark.parametrize("mode", MODES)
def test_bf16_step_matches_reference_and_float64(rng, mode):
    """One bf16 step of each trainer on the same masters, teachers and
    batch (stage 2, 32^2, N = 2): the losses within ``BF16_LOSS_REL`` of the
    reference's; each student leaf's gradient held to float64 as the module
    docstring states. The reference's gradient is read from its own Adam
    state after the step (mu = (1 - b1) g); the port's from the masters'
    ``.grad``. Masters and Adam state float32, ``rec`` float32."""
    k = 2
    student, frozen = jax_setup(mode, k)
    batch = _batch(rng)
    jt = JTrainer(JConfig(mode=mode, stage=k, compute_dtype="bfloat16"), _copy(student),
                  _copy(frozen))
    jl, _ = jt.train_step(batch)
    jgrads = jax.tree.map(lambda m: np.asarray(m, np.float64) / (1 - ADAM_B1),
                          to_np(jt.opt_state[0].mu))
    tt = Trainer(TrainConfig(mode=mode, stage=k, compute_dtype="bfloat16"), to_np(student),
                 to_np(frozen), device="cpu")
    tl, rec = tt.train_step(batch)
    _assert_losses_close(tl, jl)
    assert rec.dtype == torch.float32 and rec.shape == (2, 32, 32, 3)
    f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
    with jax.enable_x64(True):
        _, g64 = jax_losses_and_grads(mode, k, f64(student), f64(frozen),
                                      batch.astype(np.float64))
    # the floor: a float64 step on the inputs rounded to bf16 (the port's
    # float64 path; tests/test_torch_train_teacher_widths.py holds it to
    # the reference's float64 gradients)
    _, gq, _ = port_losses_and_grads(mode, k, _bf16_rounded(student), _bf16_rounded(frozen),
                                     np.asarray(_bf16_rounded(batch), np.float64),
                                     dtype=torch.float64)
    for name, leaf in g64.items():
        for kind, want in leaf.items():
            master = tt.params[name][kind]
            assert master.dtype == master.grad.dtype == torch.float32
            state = tt.opt.state[master]
            assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.float32
            mine = _rel_l2(master.grad.numpy(), want)
            ref = _rel_l2(jgrads[name][kind], want)
            floor = 2 * _rel_l2(gq[name][kind].numpy(), want)
            assert mine <= max(ref, floor), (name, kind, mine, ref, floor)
    assert all(t.grad is None and t.dtype == BF16 for f in tt.frozen.values()
               for leaf in f.values() for t in leaf.values())


@pytest.mark.parametrize("mode", MODES)
def test_bf16_trainer_tracks_float32_and_learns(rng, mode):
    """The port's mirror of the reference's ``test_mixed_precision_training_step``
    (tests/test_train.py), per mode at stage 1: the bf16 and float32 first
    steps' losses within 10 %, the masters float32, ``rec`` float32, and
    the loss falling over 8 more bf16 steps on the batch."""
    student, frozen = jax_setup(mode, 1)
    batch = _batch(rng)
    t16, t32 = (Trainer(TrainConfig(mode=mode, stage=1, batch_size=2, compute_dtype=dt),
                        to_np(student), to_np(frozen), device="cpu")
                for dt in ("bfloat16", "float32"))
    l16, rec = t16.train_step(batch)
    l32, _ = t32.train_step(batch)
    assert rec.dtype == torch.float32
    for name, v in l16.items():
        v16, v32 = float(v), float(l32[name])
        assert np.isfinite(v16) and v.dtype == torch.float32
        assert abs(v16 - v32) / max(abs(v32), 1e-6) < 0.1, (name, v16, v32)
    assert all(t.dtype == torch.float32 for leaf in t16.params.values() for t in leaf.values())
    first = sum(float(v) for v in l16.values())
    for _ in range(8):
        losses, _ = t16.train_step(batch)
    assert sum(float(v) for v in losses.values()) < first


@pytest.mark.parametrize("mode", MODES)
def test_bf16_checkpoints_resume_across_packages(rng, tmp_path, mode):
    """A bf16 checkpoint of each package resumed by the other (stage 1): the
    same keys, dtypes and shapes, float32 masters; the port restores the
    reference's params bit for bit, and each resumed trainer's next step
    has the losses of the trainer that wrote the checkpoint, within
    ``BF16_LOSS_REL``."""
    b1, b2 = _batch(rng), _batch(rng)
    student, frozen = jax_setup(mode, 1)
    cfg = dict(mode=mode, stage=1, compute_dtype="bfloat16")
    pair = lambda: (JTrainer(JConfig(**cfg), _copy(student), _copy(frozen)),
                    Trainer(TrainConfig(**cfg), to_np(student), to_np(frozen), device="cpu"))
    jt, tt = pair()
    jt.train_step(b1)
    tt.train_step(b1)
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jt.save(jpath, epoch=1, step=1)
    tt.save(tpath, epoch=1, step=1)
    with np.load(jpath + ".npz") as a, np.load(tpath + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape for k in a.files)
        assert all(b[k].dtype == np.float32 for k in b.files if k.startswith("params/"))
        jparams = {k: a[k] for k in a.files if k.startswith("params/")}
    jt2, tt2 = pair()
    tt2.restore(jpath)
    jt2.restore(tpath)
    for key, want in jparams.items():
        _, name, kind = key.split("/")
        got = tt2.params[name][kind]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.detach().numpy(), want)
    _assert_losses_close(tt2.train_step(b2)[0], jt.train_step(b2)[0])
    _assert_losses_close(jt2.train_step(b2)[0], tt.train_step(b2)[0])


# ---- ContentStylePairDataset ----------------------------------------------------

def _png_folder(path, sizes, seed):
    path.mkdir()
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path / f"{i}.png")
    return str(path)


def test_content_style_pairs_equal_reference(tmp_path):
    """Three contents and five styles: five pairs, the contents taken modulo
    three, each folder's crops drawn from its own seed (``seed``,
    ``seed + 1``); every array bit-equal to the reference's."""
    content = _png_folder(tmp_path / "c", [(70, 90), (64, 64), (100, 66)], 0)
    style = _png_folder(tmp_path / "s", [(80, 80), (66, 99), (90, 70), (72, 64), (64, 100)], 1)
    kw = dict(shorter_side=72, crop=48, seed=4)
    mine, ref = (ContentStylePairDataset(content, style, **kw),
                 jpipe.ContentStylePairDataset(content, style, **kw))
    assert len(mine) == len(ref) == 5
    for idx in [0, 1, 2, 3, 4, 4, 0]:
        (c, s), (rc, rs) = mine[idx], ref[idx]
        for a, b in ((c, rc), (s, rs)):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (48, 48, 3)
            np.testing.assert_array_equal(a, b)


# ---- the Functions' bf16 backward -----------------------------------------------

def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(((rng.random(shape, dtype=np.float32) - 0.5) * 2 * scale)).to(BF16)


def _partial_sums(x, w, b, g):
    """Elementwise, the largest magnitude a partial sum of each gradient can
    take: the plain conv's autograd on |x|, |w|, |b| with |g|."""
    ab = [t.detach().float().abs().requires_grad_() for t in (x, w, b)]
    return torch.autograd.grad(kconv.conv3x3_plain(*ab, False), ab, g.float().abs())


@pytest.mark.parametrize("shape", [(2, 7, 9, 5, 6), (1, 1, 1, 16, 16), (2, 8, 8, 3, 16),
                                   (1, 6, 5, 64, 32)], ids=str)
@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_bf16_backward_matches_plain_autograd(rng, shape, relu):
    """The ``Conv3x3`` Function in bf16 against autograd through the bf16
    plain version (float32 sums, one rounding), under the Function's ReLU
    decisions: every gradient bf16; dw and db within one bf16 ulp (2^-7
    |ref|) plus 1e-5 of their largest partial sum (float32 sums in another
    order); dx within one ulp of itself and of its elementwise partial sum
    (the reflect pad's gradient folds onto the border in bf16 after the
    data gradient rounds, where the plain version folds in float32)."""
    n, h, w, ci, co = shape
    x = _bf16(rng, n, h, w, ci).requires_grad_()
    wt = _bf16(rng, 3, 3, ci, co, scale=(3 / (9 * ci)) ** 0.5).requires_grad_()
    b = _bf16(rng, co).requires_grad_()
    g = _bf16(rng, n, h, w, co)
    y = tconv.conv3x3(x, wt, b, relu=relu)
    assert y.dtype == BF16
    got = torch.autograd.grad(y, (x, wt, b), g)
    with torch.no_grad():
        pre = kconv.conv3x3_plain(x, wt, b, False)
        assert torch.equal(y, pre.clamp_min(0) if relu else pre)
        gp = g * torch.where(pre > 0, 1.0, torch.where(pre == 0, 0.5, 0.0)) if relu else g
    want = torch.autograd.grad(kconv.conv3x3_plain(x, wt, b, False), (x, wt, b), gp.to(BF16))
    scale = _partial_sums(x, wt, b, gp)
    for i, (a, r, s) in enumerate(zip(got, want, scale)):
        assert a.dtype == BF16, i
        a, r = a.float(), r.float()
        bound = (r.abs() + s) * 2 ** -7 if i == 0 else r.abs() * 2 ** -7 + 1e-5 * s.max()
        assert bool(((a - r).abs() <= bound).all()), (i, float((a - r).abs().max()))


def _old_conv3x3_backward(x, w, y, zero, g, relu):
    """The float32 backward as it stood before it took bf16, written out."""
    if relu:
        g = g * torch.where(y > 0, 1.0, torch.where(zero, 0.5, 0.0))
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    gn = g.permute(0, 3, 1, 2)
    gp = conv2d_input((n, cin, h + 2, wd + 2), w.permute(3, 2, 0, 1), gn).permute(0, 2, 3, 1)
    rows = gp.new_zeros(n, h, wd + 2, cin).index_add_(1, reflect_index(h, 1, 1, gp.device), gp)
    gx = gp.new_zeros(n, h, wd, cin).index_add_(2, reflect_index(wd, 1, 1, gp.device), rows)
    xp = reflect_pad(x, 1).permute(0, 3, 1, 2)
    gw = conv2d_weight(xp, (cout, cin, 3, 3), gn).permute(2, 3, 1, 0).contiguous()
    return gx, gw, g.sum(dim=(0, 1, 2))


@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_float32_backward_is_bit_unchanged(rng, relu):
    """The float32 backward, ReLU ties included, bit for bit what it was."""
    x = torch.from_numpy(rng.standard_normal((2, 6, 7, 8)).astype(np.float32)).requires_grad_()
    wt = torch.from_numpy((rng.standard_normal((3, 3, 8, 12)) / 9).astype(np.float32))
    wt[:, :, :, :3] = 0   # outputs exactly 0 under the ReLU where the bias is
    b = torch.zeros(12)
    b[3:] = torch.from_numpy(rng.standard_normal(9).astype(np.float32))
    wt.requires_grad_()
    b.requires_grad_()
    g = torch.from_numpy(rng.standard_normal((2, 6, 7, 12)).astype(np.float32))
    y = tconv.conv3x3(x, wt, b, relu=relu)
    got = torch.autograd.grad(y, (x, wt, b), g)
    with torch.no_grad():
        pre = kconv.conv3x3_plain(x, wt, b, False)
        assert int((pre == 0).sum()) > 0
        want = _old_conv3x3_backward(x, wt, pre.clamp_min(0), pre == 0, g, relu)
    for a, r in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, r)


@pytest.mark.parametrize("shape", [(2, 6, 8, 3), (1, 7, 9, 4), (1, 3, 5, 2), (2, 16, 16, 64)],
                         ids=str)
def test_pool_and_upsample_bf16_backward(rng, shape):
    """In bf16: the pool's gradient at each window's first maximum, exactly
    as ``F.max_pool2d``'s (whole numbers: ties in most windows); the
    upsample's 2x2 sums of any bf16 gradient rounded once; both bf16."""
    x = torch.from_numpy(rng.integers(0, 3, shape).astype(np.float32)).to(BF16).requires_grad_()
    y = tconv.max_pool_2x2(x)
    g = _bf16(rng, *y.shape, scale=4.0)
    got = torch.autograd.grad(y, x, g)[0]
    want = torch.autograd.grad(torch.nn.functional.max_pool2d(
        x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1), x, g)[0]
    assert y.dtype == got.dtype == BF16
    assert torch.equal(got, want) and torch.equal(y, kpool.max_pool_2x2_plain(x.detach()))
    n, h, w, c = shape
    u = _bf16(rng, *shape).requires_grad_()
    gu = _bf16(rng, n, 2 * h, 2 * w, c)
    up = tconv.upsample_nearest_2x(u)
    got = torch.autograd.grad(up, u, gu)[0]
    want = gu.float().reshape(n, h, 2, w, 2, c).sum(dim=(2, 4)).to(BF16)
    assert up.dtype == got.dtype == BF16 and torch.equal(got, want)
    assert torch.equal(up, kpool.upsample_nearest_2x_plain(u.detach()))


def test_relu_adapter_bf16_gradient_is_exact():
    """The aux adapters' ReLU in bf16: 1 above 0, 0.5 at 0, 0 below, the
    gradient bf16."""
    y = torch.tensor([[-1.0, 0.0, 2.0]], dtype=BF16, requires_grad=True)
    out = tconv.conv1x1(y, torch.eye(3, dtype=BF16).reshape(1, 1, 3, 3), None, relu=True)
    g = torch.tensor([[3.0, 3.0, 3.0]], dtype=BF16)
    (gy,) = torch.autograd.grad(out, y, g)
    assert gy.dtype == BF16 and gy.tolist() == [[0.0, 1.5, 3.0]]


# ---- the bf16 conv's plan at the training steps' shapes -------------------------

def _train_shapes():
    import chip_smoke
    return sorted({s[:5] for mode in MODES for s in chip_smoke.train_conv_calls(mode)})


@pytest.mark.parametrize("shape", _train_shapes(), ids=str)
def test_bf16_conv_plans_every_training_shape(shape):
    """Every conv of the three stage-5 steps at N = 16 (Cin 3 at 256^2, the
    teachers' 256/512 at 16^2-64^2) has a bf16 launch plan that fits an H100
    (132 SMs, 232,448 B of shared memory): whole Cout tiles, at most one
    block an SM, weights resident to Cin 128 and streamed beyond."""
    n, h, w, ci, co = shape
    assert n == 16
    p = kconv.launch_plan_bf16(n, h, w, ci, co, 132)
    nt = kconv.BF16_TEMPLATES[p.template][3]
    assert p.smem <= kconv.MAX_SMEM and p.grid[0] <= 132 and p.grid[0] % -(-co // nt) == 0
    assert p.resident == (ci <= 128) and n <= kconv.MAX_GRID_Z
