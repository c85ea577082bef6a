"""The port's row-halo exchange (its plain version, on the CPU) against the
reference's two: the Pallas remote-DMA kernel in TPU interpret mode and the
``ppermute`` implementation under ``shard_map``, on the virtual CPU mesh.

A halo exchange copies rows, so every comparison is bit for bit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from collaborative_distillation_tpu.ops.pallas.halo import halo_exchange_rows_pallas
from collaborative_distillation_tpu.parallel.spatial import (
    _exchange_row_halos as jax_exchange_row_halos)

import torch
import torch.nn.functional as F

from collaborative_distillation_tpu_torch.ops.cuda import halo as khalo
from collaborative_distillation_tpu_torch.parallel import spatial as tsp

N_DEV = 4
SPEC = P(None, "space", None, None)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _space_mesh(n=N_DEV):
    # the interpret-mode DMA simulation takes single-axis meshes only
    return Mesh(np.array(jax.devices()[:n]), ("space",))


def _jax_ppermute(img, hm, mesh=None, spec=SPEC):
    mesh = mesh or _space_mesh()
    return np.asarray(shard_map(lambda x: jax_exchange_row_halos(x, hm, "space"),
                                mesh=mesh, in_specs=spec, out_specs=spec)(jnp.asarray(img)))


def _jax_pallas(img, hm):
    return np.asarray(shard_map(
        lambda x: halo_exchange_rows_pallas(x, hm, "space", interpret=True),
        mesh=_space_mesh(), in_specs=SPEC, out_specs=SPEC, check_vma=False)(jnp.asarray(img)))


def _port(img, hm, n=N_DEV):
    """The port's exchange over ``n`` CPU row shards, joined as ``shard_map``
    joins its outputs."""
    shards = list(torch.from_numpy(img).chunk(n, dim=1))
    return torch.cat(tsp._exchange_row_halos(shards, hm), dim=1).numpy()


@pytest.mark.parametrize("hm", [1, 2, 4, 8], ids=lambda h: f"hm{h}")
def test_plain_halo_equals_pallas_kernel_and_ppermute(rng, hm):
    """4 shards of 8 rows; hm = 8 is the whole neighbour (hm == H_loc)."""
    img = rng.random((1, 8 * N_DEV, 16, 8), np.float32)
    got = _port(img, hm)
    assert got.shape == (1, (8 + 2 * hm) * N_DEV, 16, 8)
    np.testing.assert_array_equal(got, _jax_ppermute(img, hm))
    np.testing.assert_array_equal(got, _jax_pallas(img, hm))
    # zero fill at the two global edges, the neighbours' rows inside
    assert not got[:, :hm].any() and not got[:, -hm:].any()
    np.testing.assert_array_equal(got[:, 8 + 2 * hm:8 + 3 * hm], img[:, 8 - hm:8])


def test_plain_halo_batch_of_two_and_odd_row_size(rng):
    """N = 2 in one tensor (each image takes its own neighbour rows) at a
    row of W*C = 15 elements."""
    img = rng.random((2, 8 * N_DEV, 5, 3), np.float32)
    np.testing.assert_array_equal(_port(img, 2), _jax_ppermute(img, 2))


def test_plain_halo_on_a_data_by_space_grid(rng):
    """(data=2, space=4): each data row exchanges within itself only, as the
    reference's ppermute over ``space`` and its mesh-coordinate kernel do."""
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "space"))
    spec = P("data", "space", None, None)
    img = rng.random((2, 8 * 4, 16, 8), np.float32)
    ref = _jax_ppermute(img, 2, mesh, spec)
    pallas = np.asarray(shard_map(
        lambda x: halo_exchange_rows_pallas(x, 2, "space", interpret=True,
                                            extra_vma=("data",)),
        mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)(jnp.asarray(img)))
    got = np.concatenate([_port(img[i:i + 1], 2) for i in range(2)])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)


def test_plain_halo_feeds_a_valid_conv_exactly(rng):
    """The exchanged rows are the true neighbour rows: a 3x3 valid conv over
    each extended shard equals the same conv over the unsharded image."""
    img = rng.random((1, 8 * N_DEV, 16, 4), np.float32)
    w = rng.random((3, 3, 4, 4), np.float32)

    def conv_valid(x):
        y = F.conv2d(x.permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1))
        return y.permute(0, 2, 3, 1)

    full = conv_valid(torch.from_numpy(img)).numpy()   # (1, H-2, 14, 4)
    shards = list(torch.from_numpy(img).chunk(N_DEV, dim=1))
    tiled = torch.cat([conv_valid(e) for e in tsp._exchange_row_halos(shards, 1)],
                      dim=1).numpy()
    # shard 0's first row and the last shard's last row read the zero fill
    np.testing.assert_allclose(tiled[:, 1:-1], full, rtol=1e-5, atol=1e-5)
    want = jax.lax.conv_general_dilated(jnp.asarray(img), jnp.asarray(w), (1, 1), "VALID",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(tiled[:, 1:-1], np.asarray(want), rtol=1e-5, atol=1e-5)


def test_halo_sources_may_be_any_rows(rng):
    """The plain version takes a source per side: a neighbour's rows, the
    shard's own reflection row, or None for zeros."""
    x = torch.from_numpy(rng.random((2, 6, 5, 3), np.float32))
    ext = khalo.halo_exchange_rows_plain(x, x[:, 1:2], None, 1)
    assert ext.shape == (2, 8, 5, 3)
    assert torch.equal(ext[:, :1], x[:, 1:2]) and torch.equal(ext[:, 1:7], x)
    assert not ext[:, 7:].any()


def test_halo_refusals(rng):
    x = torch.from_numpy(rng.random((1, 4, 5, 3), np.float32))
    shards = [x, x.clone()]
    with pytest.raises(ValueError, match="at least as many"):
        tsp._exchange_row_halos(shards, 5)          # hm > H_loc
    with pytest.raises(ValueError):
        tsp._exchange_row_halos(shards, 0)          # hm = 0
    for fn in (khalo.halo_exchange_rows_plain, khalo.halo_exchange_rows):
        with pytest.raises(ValueError, match="positive"):
            fn(x, None, None, 0)
        with pytest.raises(ValueError, match="float64"):
            fn(x, x[:, :2].double(), None, 2)       # mixed dtypes
        with pytest.raises(ValueError, match="rows"):
            fn(x, x[:, :1], None, 2)                # one row where two are due
    with pytest.raises(ValueError, match="CUDA"):
        khalo.halo_exchange_rows(x, None, x[:, :2], 2)   # the kernel takes no CPU tensor
    assert khalo.halo_exchange_rows.launches == 0
