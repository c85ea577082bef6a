"""The whole cascade as one function (``stylize_cascade_fn``) in the
PyTorch port, on the CPU: against the reference package's function of the
same name, the oracle of tests/test_engine.py, tests/test_slab.py and
tests/test_spatial.py (PSNR >= 40 dB on the photo pair, under the 43.5 dB
float32 reordering floor of real content), and against the port's own plain
engine, which runs the same ops on the same inputs (1e-6 max abs).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from collaborative_distillation_tpu.models.zoo import load_pyramid as jax_load_pyramid
from collaborative_distillation_tpu.wct.engine import stylize_cascade_fn as jax_cascade_fn

import torch

from collaborative_distillation_tpu_torch.utils.params import pyramid_from_jax
from collaborative_distillation_tpu_torch.wct import slab as tslab
from collaborative_distillation_tpu_torch.wct.engine import WCTEngine, stylize_cascade_fn

PSNR_MIN_DB = 40.0
SAME_OPS_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2))


@pytest.fixture(scope="module")
def pyramids(weights_root):
    jp = jax_load_pyramid("16x", weights_root)
    tp = pyramid_from_jax({k: {**v, "enc": jax.tree.map(np.asarray, v["enc"]),
                               "dec": jax.tree.map(np.asarray, v["dec"])}
                           for k, v in jp.items()})
    return jp, tp


@pytest.fixture(scope="module")
def photo():
    with np.load(os.path.join(os.path.dirname(tslab.__file__), os.pardir, "data",
                              "photo_pair_512.npz")) as d:
        return (d["content"][:256, :256].astype(np.float32) / 255.0,
                d["style"][128:384, 128:384].astype(np.float32) / 255.0)


@pytest.mark.parametrize("stages,alpha", [((5, 4, 3, 2, 1), 1.0), ((3, 2, 1), 0.6)], ids=str)
def test_cascade_fn_matches_reference(pyramids, photo, stages, alpha):
    jp, tp = pyramids
    c, s = (x[None] for x in photo)
    got = stylize_cascade_fn(tp, stages=stages)(tp, torch.from_numpy(c), torch.from_numpy(s),
                                                alpha)
    jparams = {k: {"enc": jp[k]["enc"], "dec": jp[k]["dec"]} for k in stages}
    want = np.asarray(jax_cascade_fn(jp, stages=stages)(jparams, jnp.asarray(c),
                                                        jnp.asarray(s), alpha))
    assert got.shape == want.shape == c.shape and torch.isfinite(got).all()
    assert _psnr(np.clip(got.numpy(), 0, 1), np.clip(want, 0, 1)) >= PSNR_MIN_DB


@pytest.mark.parametrize("n", [1, 2])
def test_cascade_fn_equals_the_plain_engine(pyramids, photo, n):
    """Same kernels (here their plain versions) on the same inputs: the
    engine's unclipped output and the function's agree to 1e-6; a batch
    takes per-image style statistics in both."""
    _, tp = pyramids
    c, s = photo
    c = np.stack([c, c[::-1]])[:n, :128, :96]
    s = np.stack([s, s[:, ::-1]])[:n, :112, :80]
    eng = WCTEngine(pyramid=tp, device="cpu")
    fn = stylize_cascade_fn(tp)
    with torch.inference_mode():
        img, sty = eng._prep(c), eng._prep(s)
        got = fn(tp, img, sty, 0.8)
        want = eng._run(img, sty, 0.8, num_run=1, style_key=None)
        clipped = eng.stylize_device(torch.from_numpy(c), torch.from_numpy(s), 0.8)
    assert got.shape == (n, 128, 96, 3)
    assert float((got - want).abs().max()) <= SAME_OPS_TOL
    assert float((torch.clamp(got, 0, 1) - clipped).abs().max()) <= SAME_OPS_TOL
