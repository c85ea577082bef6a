"""The port's slab-in-shard cascade (``parallel/spatial.py``:
``build_tiled_slab_cascade``, ``slab_coords``) on ``devices=["cpu"] * n``
against the reference package's on the virtual CPU mesh, with the toy
pyramid and images of tests/test_tiled_slab.py.

Tolerance: whole cascades on the random toy pyramid are held to atol 3e-3,
the reference's own bar between its sharded and single-chip slab cascades
(float32 sums reordered through ``eigh`` on near-degenerate covariances).
The slab coordinates are integers and must be equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from collaborative_distillation_tpu.models.specs import decoder_spec, encoder_spec
from collaborative_distillation_tpu.models.vgg import init_params
from collaborative_distillation_tpu.parallel import spatial as jsp
from collaborative_distillation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from collaborative_distillation_tpu.wct import slab as jslab

import torch

from collaborative_distillation_tpu_torch.parallel import spatial as tsp
from collaborative_distillation_tpu_torch.parallel.mesh import make_mesh
from collaborative_distillation_tpu_torch.utils.params import pyramid_from_jax
from collaborative_distillation_tpu_torch.wct import slab as tslab

STAGES = (3, 2, 1)
ATOL = 3e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process: the suite runs several test
    processes at once, and torch's CPU parallel regions slow down by orders
    of magnitude when their threads outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(pyr):
    return {k: {**v, "enc": jax.tree.map(np.asarray, v["enc"]),
                "dec": jax.tree.map(np.asarray, v["dec"])} for k, v in pyr.items()}


def _toy_pyramid(stages, seed):
    key = jax.random.key(seed)
    pyr = {}
    for s in stages:
        key, k1, k2 = jax.random.split(key, 3)
        espec, dspec = encoder_spec("16x", s, aux=True), decoder_spec("16x", s)
        pyr[s] = {"enc_spec": espec, "dec_spec": dspec,
                  "enc": init_params(espec, k1), "dec": init_params(dspec, k2)}
    return pyr


@pytest.fixture(scope="module")
def pyramids():
    jp = _toy_pyramid(STAGES, 7)
    return jp, pyramid_from_jax(_np_tree(jp))


@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(0)
    return rng.random((1, 192, 48, 3), np.float32), rng.random((1, 64, 48, 3), np.float32)


def _cpu_mesh(space, data=1):
    return make_mesh(data=data, space=space, devices=["cpu"] * (data * space))


def _shards(x, n):
    return [p.contiguous() for p in torch.from_numpy(np.asarray(x)).chunk(n, dim=1)]


def _join(shards):
    return torch.cat(shards, dim=1).numpy()


def _slab_for(tp, target):
    return tslab.SlabCascade(tp, stages=STAGES, slab_rows=target).slab_rows


@pytest.mark.parametrize("halo", ["ppermute", "pallas"])
@pytest.mark.parametrize("space,target,rows", [(4, 48, 192), (2, 96, None)],
                         ids=["space4", "two_shards_one_slab_each"])
def test_tiled_slab_cascade_matches_reference(pyramids, imgs, halo, space, target, rows):
    """The sharded slab cascade against the reference's with either halo
    implementation, and against the port's own single-device fused slab
    cascade at the same slab size (the global slab boundaries coincide)."""
    jp, tp = pyramids
    c, s = imgs
    slab = _slab_for(tp, target)
    c = c[:, :rows or slab * space]
    assert c.shape[1] % (slab * space) == 0
    jfn, jparams = jsp.build_tiled_slab_cascade(jp, jax_make_mesh(space=space), stages=STAGES,
                                                slab_rows=slab, halo=halo)
    want = np.asarray(jfn(jparams, jnp.asarray(c), jnp.asarray(s), 0.8))
    fn = tsp.build_tiled_slab_cascade(tp, _cpu_mesh(space), stages=STAGES, slab_rows=slab)
    assert fn.slab_rows == jfn.slab_rows == slab
    got = _join(fn(_shards(c, space), torch.from_numpy(s), 0.8))
    assert got.shape == want.shape == c.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    single = tslab.build_fused_slab_cascade(tp, stages=STAGES, slab_rows=slab)(
        torch.from_numpy(c), torch.from_numpy(s), 0.8).numpy()
    np.testing.assert_allclose(got, single, atol=ATOL, rtol=0)


def test_data_by_space_grid_equals_two_space_only_runs(pyramids, imgs, rng):
    jp, tp = pyramids
    c, s = imgs
    slab = _slab_for(tp, 48)
    c2 = np.concatenate([c, rng.random(c.shape, np.float32)])
    s2 = np.concatenate([s, rng.random(s.shape, np.float32)])
    fn = tsp.build_tiled_slab_cascade(tp, _cpu_mesh(4, data=2), stages=STAGES, slab_rows=slab,
                                      data_axis="data")
    rows = fn([_shards(c2[i:i + 1], 4) for i in range(2)],
              [torch.from_numpy(s2[i:i + 1]) for i in range(2)], 1.0)
    sfn = tsp.build_tiled_slab_cascade(tp, _cpu_mesh(4), stages=STAGES, slab_rows=slab)
    jfn, jparams = jsp.build_tiled_slab_cascade(jp, jax_make_mesh(data=2, space=4),
                                                stages=STAGES, slab_rows=slab,
                                                data_axis="data")
    want = np.asarray(jfn(jparams, jnp.asarray(c2), jnp.asarray(s2), 1.0))
    for i in range(2):
        alone = _join(sfn(_shards(c2[i:i + 1], 4), torch.from_numpy(s2[i:i + 1]), 1.0))
        np.testing.assert_array_equal(_join(rows[i]), alone)
        np.testing.assert_allclose(alone, want[i:i + 1], atol=ATOL, rtol=0)


def test_tiny_slab_request_rounds_up_like_the_reference(pyramids, imgs):
    jp, tp = pyramids
    c, s = imgs
    fn = tsp.build_tiled_slab_cascade(tp, _cpu_mesh(4), stages=STAGES, slab_rows=4)
    jfn, _ = jsp.build_tiled_slab_cascade(jp, jax_make_mesh(space=4), stages=STAGES,
                                          slab_rows=4)
    assert fn.slab_rows == jfn.slab_rows >= 2 * tslab.SlabCascade(tp, stages=STAGES,
                                                                  slab_rows=4).margin
    mult = fn.slab_rows * 4
    hp = -(-c.shape[1] // mult) * mult
    cp = np.pad(c, ((0, 0), (0, hp - c.shape[1]), (0, 0), (0, 0)), mode="reflect")
    out = fn(_shards(cp, 4), torch.from_numpy(s), 1.0)
    assert _join(out).shape == cp.shape
    with pytest.raises(ValueError, match="multiple of slab_rows"):
        fn(_shards(c[:, :mult - 16], 4), torch.from_numpy(s), 1.0)
    with pytest.raises(ValueError, match="single device"):
        tsp.build_tiled_slab_cascade(tp, _cpu_mesh(1), stages=STAGES)


@pytest.mark.parametrize("stages,target,space,n_slabs",
                         [(STAGES, 48, 4, 1), (STAGES, 48, 4, 3), (STAGES, 96, 2, 1),
                          ((5, 4, 3, 2, 1), 512, 4, 2), ((5, 4, 3, 2, 1), 288, 8, 1)], ids=str)
def test_slab_coords_equal_the_reference_plan(stages, target, space, n_slabs):
    """Every (shard, slab, stage): the port's coordinates, moved from the
    halo-extended shard's rows to the image's (ext row 0 = global row
    d * h_loc - hm), are the reference ``SlabCascade._slabs`` of the whole
    image, whose boundaries the sharded cascade shares; and they equal the
    reference's own arithmetic (parallel/spatial.py:452-469) written out."""
    pyr = {k: {"enc_spec": encoder_spec("16x", k, aux=True),
               "dec_spec": decoder_spec("16x", k)} for k in stages}
    ref = jslab.SlabCascade(pyr, stages=stages, slab_rows=target)
    slab = ref.slab_rows
    assert slab >= 2 * ref.margin
    h_loc = n_slabs * slab
    for k in stages:
        m = ref.margins[k]
        hm = 2 * m
        whole = list(ref._slabs(h_loc * space, k))
        for d in range(space):
            first, last = d == 0, d == space - 1
            for i in range(n_slabs):
                start, off = tsp.slab_coords(i, slab=slab, m=m, hm=hm, h_loc=h_loc,
                                             is_first=first, is_last=last)
                g_start, g_rows, g_off = whole[d * n_slabs + i]
                assert (start + d * h_loc - hm, slab + hm, off) == (g_start, g_rows, g_off)
                assert 0 <= start and start + slab + hm <= h_loc + 2 * hm
                # never the zero fill of a global edge
                assert not (first and start < hm) and not (last and start + slab + hm > h_loc + hm)
                j_start = jnp.where(last & (i == n_slabs - 1), h_loc - slab,
                                    jnp.where(first & (i == 0), hm, i * slab + m))
                j_off = jnp.where(last & (i == n_slabs - 1), hm,
                                  jnp.where(first & (i == 0), 0, m))
                assert (start, off) == (int(j_start), int(j_off))
