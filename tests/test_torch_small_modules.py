"""The PyTorch port's small modules, on the CPU, against the reference
package's functions of the same names:

* ``utils/flops.py``: ``stage_flops`` and ``cascade_flops`` exactly equal
  (the same integer arithmetic over the same spec tables), modes ``16x`` and
  ``original``; ``card_peak_flops`` for a known and an unknown card name;
* ``ops/style_stats.py``: ``gram_matrix``, ``gram_matrix_ave``,
  ``calc_mean_std`` and ``adain`` within 1e-6 of the largest output
  (float32 sums in another order);
* ``models/mobilenet.py``: the layer tables, ``fold_batchnorm`` and
  ``convert_mobilenet_state_dict`` exactly equal (the same numpy),
  ``apply_mobilenet_encoder`` within 1e-5 of the largest output, on a state
  dict synthesized as tests/test_mobilenet.py does.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from collaborative_distillation_tpu.models import mobilenet as jmob
from collaborative_distillation_tpu.models.specs import (decoder_spec as jax_decoder_spec,
                                                         encoder_spec as jax_encoder_spec)
from collaborative_distillation_tpu.ops import style_stats as jstats
from collaborative_distillation_tpu.utils import flops as jflops

import torch
from torch import nn

from collaborative_distillation_tpu_torch.models import mobilenet as tmob
from collaborative_distillation_tpu_torch.models.specs import decoder_spec, encoder_spec
from collaborative_distillation_tpu_torch.ops import style_stats as tstats
from collaborative_distillation_tpu_torch.utils import flops as tflops
from collaborative_distillation_tpu_torch.utils.params import params_from_jax

STATS_TOL = 1e-6
MOBILENET_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- utils/flops.py -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["16x", "original"])
@pytest.mark.parametrize("h,w", [(2048, 2048), (4096, 10240), (512, 384), (70, 93), (16, 16)])
def test_cascade_and_stage_flops_equal_reference(mode, h, w):
    assert tflops.cascade_flops(mode, h, w) == jflops.cascade_flops(mode, h, w)
    assert (tflops.cascade_flops(mode, h, w, stages=(3, 1))
            == jflops.cascade_flops(mode, h, w, stages=(3, 1)))
    for k in (1, 3, 5):
        for aux in (False, True) if mode == "16x" else (False,):
            for ours, theirs in ((encoder_spec(mode, k, aux=aux), jax_encoder_spec(mode, k, aux=aux)),
                                 (decoder_spec(mode, k, aux=aux), jax_decoder_spec(mode, k, aux=aux))):
                for include_aux in (False, True):
                    assert (tflops.stage_flops(ours, h, w, include_aux=include_aux)
                            == jflops.stage_flops(theirs, h, w, include_aux=include_aux))


def test_card_peak_flops_by_name():
    h100 = "NVIDIA H100 80GB HBM3"   # the SXM5 part, as torch.cuda.get_device_name gives it
    assert tflops.card_peak_flops(h100, "float32") == (67e12, "h100 80gb hbm3:float32")
    assert tflops.card_peak_flops(h100, "bf16") == (989e12, "h100 80gb hbm3:bfloat16")
    assert tflops.card_peak_flops(h100, "tf32")[0] == 495e12
    # another part, with other rates, is unknown rather than given the SXM's
    assert tflops.card_peak_flops("NVIDIA H100 PCIe") == (0.0, "NVIDIA H100 PCIe")
    assert tflops.card_peak_flops("Tesla T4") == (0.0, "Tesla T4")
    with pytest.raises(ValueError, match="dtype"):
        tflops.card_peak_flops("NVIDIA H100 80GB HBM3", "int4")


# ---- ops/style_stats.py ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 16, 16, 64), (2, 9, 13, 24), (1, 1, 1, 8)], ids=str)
def test_style_stats_equal_reference(rng, shape):
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    y = (rng.standard_normal(shape) * 0.5 - 2).astype(np.float32)
    tx, ty, jx, jy = torch.from_numpy(x), torch.from_numpy(y), jnp.asarray(x), jnp.asarray(y)

    def close(got, want):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=STATS_TOL * max(float(np.abs(want).max()), 1e-30))

    close(tstats.gram_matrix(tx), jstats.gram_matrix(jx))
    close(tstats.gram_matrix_ave(tx), jstats.gram_matrix_ave(jx))
    for got, want in zip(tstats.calc_mean_std(tx), jstats.calc_mean_std(jx)):
        close(got, want)
    close(tstats.adain(tx, ty), jstats.adain(jx, jy))


# ---- models/mobilenet.py --------------------------------------------------------

def _conv_bn(cin, cout, stride):
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, 1, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU(inplace=True))


def _conv_dw(cin, cout, stride):
    return nn.Sequential(nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False),
                         nn.BatchNorm2d(cin), nn.ReLU(inplace=True),
                         nn.Conv2d(cin, cout, 1, 1, 0, bias=False),
                         nn.BatchNorm2d(cout), nn.ReLU(inplace=True))


@pytest.fixture(scope="module")
def state_dict():
    """A seeded MobileNetV1 (blocks 0..8) in the module.model.N.M layout the
    reference's converter indexes, with BN statistics away from their init,
    as tests/test_mobilenet.py builds it."""
    torch.manual_seed(0)
    model = nn.Sequential(_conv_bn(*tmob.MOBILENET_BLOCKS[0]),
                          *[_conv_dw(*b) for b in tmob.MOBILENET_BLOCKS[1:]])
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            with torch.no_grad():
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.3, 0.3)
    return {f"module.model.{k}": v for k, v in model.state_dict().items()}


def test_mobilenet_tables_and_fold_equal_reference(rng):
    assert tmob.MOBILENET_BLOCKS == jmob.MOBILENET_BLOCKS
    assert tmob.MOBILENET_TAP_WIDTHS == jmob.MOBILENET_TAP_WIDTHS
    for stage in range(1, 6):
        assert tmob.mobilenet_layer_table(stage) == jmob.mobilenet_layer_table(stage)
        assert tmob.mobilenet_param_shapes(stage) == jmob.mobilenet_param_shapes(stage)
    with pytest.raises(ValueError, match="stage"):
        tmob.mobilenet_layer_table(6)
    args = (rng.normal(size=(3, 3, 4, 8)), rng.uniform(0.5, 1.5, 8), rng.normal(size=8),
            rng.normal(size=8), rng.uniform(0.5, 2.0, 8))
    args = [a.astype(np.float32) for a in args]
    for got, want in zip(tmob.fold_batchnorm(*args), jmob.fold_batchnorm(*args)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_mobilenet_conversion_equals_reference(state_dict):
    for stage in range(1, 6):
        got = tmob.convert_mobilenet_state_dict(state_dict, stage)
        want = jmob.convert_mobilenet_state_dict(state_dict, stage)
        assert got.keys() == want.keys()
        for name in want:
            for kind in ("w", "b"):
                np.testing.assert_array_equal(got[name][kind], want[name][kind])
    with pytest.raises(KeyError, match="missing"):
        tmob.convert_mobilenet_state_dict({}, 1)


@pytest.mark.parametrize("stage", [1, 2, 3, 5])
def test_mobilenet_encoder_equals_reference(state_dict, rng, stage):
    tree = jmob.convert_mobilenet_state_dict(state_dict, stage)
    x = rng.uniform(0, 1, (1, 40, 48, 3)).astype(np.float32)
    got = tmob.apply_mobilenet_encoder(params_from_jax(tree), torch.from_numpy(x), stage)
    want = jmob.apply_mobilenet_encoder(tree, jnp.asarray(x), stage)
    assert got.keys() == want.keys()
    for key in want:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape and got[key].is_contiguous()
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=MOBILENET_TOL * float(np.abs(w).max()))
    # numpy leaves serve as well as the carried-over tensors
    np.testing.assert_array_equal(
        tmob.apply_mobilenet_encoder(tree, torch.from_numpy(x), stage)["out"].numpy(),
        got["out"].numpy())
