"""The slab-in-shard cascade's in-place halos on the CPU: the plain version
of ``halo_fill_rows`` (``ops/cuda/halo.py``) against the reference's two
exchanges (``parallel.spatial._exchange_row_halos`` under ``shard_map`` and
the Pallas kernel in interpret mode), ``SlabCascade.color_decode_stage``
writing into a view of the next stage's extended shard, and the whole
cascade on ``devices=["cpu"] * 4`` against the same cascade with the full
exchange at every stage.

Every halo is a copy and the cascades differ only in where rows are
written, so every comparison is bit for bit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from collaborative_distillation_tpu.models.specs import decoder_spec, encoder_spec
from collaborative_distillation_tpu.models.vgg import init_params
from collaborative_distillation_tpu.ops.pallas.halo import halo_exchange_rows_pallas
from collaborative_distillation_tpu.parallel.spatial import (
    _exchange_row_halos as jax_exchange_row_halos)

import torch

from collaborative_distillation_tpu_torch.ops.cuda import halo as khalo
from collaborative_distillation_tpu_torch.ops.wct_transform import coloring_matrix, stats_from_sums
from collaborative_distillation_tpu_torch.parallel import spatial as tsp
from collaborative_distillation_tpu_torch.parallel.mesh import make_mesh
from collaborative_distillation_tpu_torch.utils.params import pyramid_from_jax
from collaborative_distillation_tpu_torch.wct import slab as tslab

SPEC = P(None, "space", None, None)
STAGES = (3, 2, 1)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "uint8": (torch.uint8, jnp.uint8)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread per test process (the suite runs several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(rng, shape, dtype: str) -> np.ndarray:
    """Values every type holds exactly: bytes for uint8, eighths in
    [-16, 16) for the floats (exact in bf16)."""
    if dtype == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    return (rng.integers(-128, 128, shape) / 8).astype(np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _written_exts(img: torch.Tensor, space: int, hm: int) -> list[torch.Tensor]:
    """Each row shard of ``img`` in the interior of an extended shard whose
    halo rows hold garbage (7), as a stage's decode leaves them."""
    exts = []
    for x in img.chunk(space, dim=1):
        e = torch.full((x.shape[0], x.shape[1] + 2 * hm, *x.shape[2:]), 7, dtype=x.dtype)
        e[:, hm:hm + x.shape[1]] = x
        exts.append(e)
    return exts


# (space, hm, N, dtype, W, C): odd row bytes (W * C * itemsize 15, 42, 21, 3)
FILL_CASES = [(2, 1, 1, "float32", 5, 3), (3, 2, 2, "bfloat16", 7, 3), (4, 3, 1, "uint8", 5, 3),
              (4, 1, 2, "float32", 16, 8), (3, 3, 1, "bfloat16", 16, 8), (2, 2, 2, "uint8", 3, 1),
              (4, 2, 1, "bfloat16", 21, 1)]


@pytest.mark.parametrize("space,hm,n,dtype,w,c", FILL_CASES, ids=str)
def test_fill_equals_reference_exchanges(rng, space, hm, n, dtype, w, c):
    """Shards of 4 rows (hm up to 3) whose interiors are written: the fill
    gives what the reference's ppermute exchange and its Pallas kernel give,
    bit for bit, zeros at the two global edges."""
    img = _values(rng, (n, 4 * space, w, c), dtype)
    tdt, jdt = DTYPES[dtype]
    exts = _written_exts(torch.from_numpy(img).to(tdt), space, hm)
    assert tsp._fill_row_halos(exts, hm) is None
    got = _bits(torch.cat(exts, dim=1))
    mesh = Mesh(np.array(jax.devices()[:space]), ("space",))
    x = jnp.asarray(img, jdt)
    ppermute = shard_map(lambda s: jax_exchange_row_halos(s, hm, "space"), mesh=mesh,
                         in_specs=SPEC, out_specs=SPEC)(x)
    pallas = shard_map(lambda s: halo_exchange_rows_pallas(s, hm, "space", interpret=True),
                       mesh=mesh, in_specs=SPEC, out_specs=SPEC, check_vma=False)(x)
    np.testing.assert_array_equal(got, _jax_bits(ppermute))
    np.testing.assert_array_equal(got, _jax_bits(pallas))
    assert not got[:, :hm].any() and not got[:, -hm:].any()


def test_fill_writes_only_the_halos_in_place(rng):
    """The interior rows keep their bits and every extended shard its
    storage; the fill equals the full exchange of the interiors."""
    hm, space = 2, 3
    img = torch.from_numpy(_values(rng, (2, 5 * space, 6, 3), "float32"))
    exts = _written_exts(img, space, hm)
    ptrs = [e.data_ptr() for e in exts]
    inner = [e[:, hm:-hm].clone() for e in exts]
    tsp._fill_row_halos(exts, hm)
    assert [e.data_ptr() for e in exts] == ptrs
    for e, x, full in zip(exts, inner, tsp._exchange_row_halos(inner, hm)):
        assert torch.equal(e[:, hm:-hm], x)
        assert torch.equal(e, full)


def test_fill_plain_takes_any_rows_and_refuses_what_does_not_fit(rng):
    ext = torch.full((2, 7, 5, 3), 9.0)
    rows = torch.from_numpy(_values(rng, (2, 2, 5, 3), "float32"))
    khalo.halo_fill_rows_plain([(ext, None, rows)], 2)
    assert not ext[:, :2].any() and torch.equal(ext[:, 5:], rows)
    assert (ext[:, 2:5] == 9.0).all()
    for items, hm, match in (([(ext, rows[:, :1], None)], 2, "rows"),
                             ([(ext, None, None)], 0, "positive"),
                             ([(ext[:, :3], None, None)], 2, "no room"),
                             ([(ext, rows.double(), None)], 2, "float64")):
        with pytest.raises(ValueError, match=match):
            khalo.halo_fill_rows_plain(items, hm)
    with pytest.raises(ValueError, match="CUDA"):
        khalo.halo_fill_rows([(ext, None, rows)], 2)   # the kernel takes no CPU tensor
    with pytest.raises(ValueError, match="at least as many"):
        tsp._fill_row_halos([ext[:, :5], ext[:, :5]], 2)   # one interior row, hm 2
    assert khalo.halo_fill_rows.launches == 0


def _toy_pyramid(seed):
    key = jax.random.key(seed)
    pyr = {}
    for s in STAGES:
        key, k1, k2 = jax.random.split(key, 3)
        espec, dspec = encoder_spec("16x", s, aux=True), decoder_spec("16x", s)
        pyr[s] = {"enc_spec": espec, "dec_spec": dspec,
                  "enc": jax.tree.map(np.asarray, init_params(espec, k1)),
                  "dec": jax.tree.map(np.asarray, init_params(dspec, k2))}
    return pyramid_from_jax(pyr)


def _cast(tree, dtype):
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype)
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def toy():
    return _toy_pyramid(7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_color_decode_stage_into_a_view_is_bit_equal(rng, toy, dtype):
    """``out=`` a view of a taller map's interior: the same bits as the
    stage's own output, the rows around the view untouched; a view of
    another shape is refused."""
    pyr = {k: _cast(v, dtype) for k, v in toy.items()}
    cas = tslab.SlabCascade(pyr, stages=STAGES, slab_rows=48)
    img = torch.from_numpy(rng.random((1, 96, 40, 3), np.float32)).to(dtype)
    sty = torch.from_numpy(rng.random((1, 48, 40, 3), np.float32)).to(dtype)
    k = STAGES[0]
    s_mean, s_cov = cas.style_stats(k, sty)
    c_mean, c_cov, _ = cas.content_stats(k, img)
    t = coloring_matrix(c_cov, s_cov.float())
    alpha = torch.tensor(0.8)
    want = cas.color_decode_stage(k, img, t, c_mean, s_mean, alpha)
    hn = 5
    buf = torch.full((1, 96 + 2 * hn, 40, 3), 3.0, dtype=dtype)
    got = cas.color_decode_stage(k, img, t, c_mean, s_mean, alpha, out=buf[:, hn:hn + 96])
    assert got.data_ptr() == buf[:, hn:].data_ptr()
    assert torch.equal(_bits_t(buf[:, hn:hn + 96]), _bits_t(want))
    assert (buf[:, :hn] == 3).all() and (buf[:, hn + 96:] == 3).all()
    with pytest.raises(ValueError, match="out is"):
        cas.color_decode_stage(k, img, t, c_mean, s_mean, alpha, out=buf[:, :96 - 1])


def _bits_t(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _full_exchange_cascade(pyr, shards, style, alpha, slab):
    """The slab-in-shard cascade as it ran with the full exchange at every
    stage: each stage extends its input shards whole with the plain
    ``halo_exchange_rows`` and decodes into new plain shards."""
    cas = tslab.SlabCascade(pyr, stages=STAGES, slab_rows=slab)
    n = len(shards)
    parts = list(shards)
    alpha = torch.as_tensor(alpha, dtype=torch.float32)
    for k in STAGES:
        m = cas.margins[k]
        hm = 2 * m
        s_mean, s_cov = cas.style_stats(k, style)
        ext = [khalo.halo_exchange_rows_plain(x, parts[d - 1][:, -hm:] if d else None,
                                              parts[d + 1][:, :hm] if d < n - 1 else None, hm)
               for d, x in enumerate(parts)]
        coords = [[(start, slab + hm, off, min(slab, x.shape[1] - i * slab))
                   for i in range(-(-x.shape[1] // slab))
                   for start, off in [tsp.slab_coords(i, slab=slab, m=m, hm=hm, h_loc=x.shape[1],
                                                      is_first=j == 0, is_last=j == n - 1)]]
                  for j, x in enumerate(parts)]
        shift, s_sum, g_sum, count = None, 0.0, 0.0, 0
        for j in range(n):
            first, s, g, n_px, _ = cas.slab_sums(k, ext[j], coords[j], shift=shift)
            shift = first if shift is None else shift
            s_sum, g_sum, count = s_sum + s, g_sum + g, count + n_px
        c_mean, c_cov = stats_from_sums(shift, s_sum, g_sum, count)
        t = coloring_matrix(c_cov, s_cov.float())
        parts = [cas.color_decode_stage(k, ext[j], t, c_mean, s_mean.float(), alpha,
                                        slabs=coords[j]) for j in range(n)]
    return parts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("windows", [(1, 1, 1, 1), (2, 1, 1, 1), (1, 1, 1, 0)], ids=str)
def test_cascade_extends_once_then_fills_in_place(rng, toy, monkeypatch, dtype, windows):
    """Four shards on ``devices=["cpu"] * 4`` (one window each, two on the
    first, or none on the last, which sits out): the full exchange runs at
    the first stage only, one per live shard, the fill once a stage on the
    one device, and the output equals the full-exchange cascade bit for
    bit."""
    pyr = {k: _cast(v, dtype) for k, v in toy.items()}
    fn = tsp.build_tiled_slab_cascade(pyr, make_mesh(space=4, devices=["cpu"] * 4),
                                      stages=STAGES, slab_rows=48)
    slab = fn.slab_rows
    rows = [w * slab for w in windows]
    img = torch.from_numpy(rng.random((1, sum(rows), 40, 3), np.float32)).to(dtype)
    sty = torch.from_numpy(rng.random((1, 48, 40, 3), np.float32)).to(dtype)
    shards = [p.contiguous() for p in img.split(rows, dim=1)]
    calls = []
    exchange, fill = khalo.halo_exchange_rows_plain, khalo.halo_fill_rows_plain
    monkeypatch.setattr(khalo, "halo_exchange_rows_plain",
                        lambda x, top, bot, hm: calls.append(("exchange", hm))
                        or exchange(x, top, bot, hm))
    monkeypatch.setattr(khalo, "halo_fill_rows_plain",
                        lambda items, hm: calls.append(("fill", hm, len(items)))
                        or fill(items, hm))
    out = fn(shards, sty, 0.8)
    margins = tslab.SlabCascade(pyr, stages=STAGES, slab_rows=slab).margins
    live = sum(w > 0 for w in windows)
    assert calls == ([("exchange", 2 * margins[STAGES[0]])] * live
                     + [("fill", 2 * margins[k], live) for k in STAGES[1:]])
    assert [o.shape[1] for o in out] == rows and out[0].dtype == dtype
    monkeypatch.setattr(khalo, "halo_exchange_rows_plain", exchange)
    want = _full_exchange_cascade(pyr, shards[:live], sty, 0.8, slab)
    for got, ref in zip(out, want):
        assert torch.equal(_bits_t(got), _bits_t(ref))
    assert all(o is s for o, s in zip(out[live:], shards[live:]))   # sat out


def test_chip_smoke_plans_one_exchange_then_a_fill_a_stage():
    """``chip_smoke.py``'s plan of the slab-in-shard UHD cascade (four
    shards, ``slab_rows=512``): one exchange of the card's four shards at
    stage 5 and one fill before each later stage, 5 launches on one card
    and 1 + 4 on each card where the shards are spread; their bound at
    3.35 TB/s is the 15,808 rows of 61,440 bytes (bf16) the halos move."""
    import chip_smoke
    from collaborative_distillation_tpu_torch.models.zoo import stage_specs
    stages = (5, 4, 3, 2, 1)
    pyr = {k: dict(zip(("enc_spec", "dec_spec"), stage_specs("16x", k))) for k in stages}
    margins = tslab.SlabCascade(pyr, stages=stages, slab_rows=1024).margins

    def halos(devices=None):
        calls, _ = chip_smoke.sharded_path_calls(pyr, stages, margins, 512, 4, 4096, 10240,
                                                 2048, 2048, devices=devices)
        return {(k, s): n for (k, s), n in calls.items() if k in chip_smoke.SHARDED_ONLY}

    one = halos()
    assert sorted((k, s[4], s[5], n) for (k, s), n in one.items()) == [
        ("halo_exchange_rows", 288, 4, 1), ("halo_fill_rows", 32, 4, 2),
        ("halo_fill_rows", 64, 4, 1), ("halo_fill_rows", 128, 4, 1)]
    row = 10240 * 3 * 2
    moved = sum(chip_smoke.work(k, s, 2)[0] * n for (k, s), n in one.items())
    assert moved == 15808 * row
    assert round(moved / chip_smoke.PEAK_BYTES * 1e3, 3) == 0.290
    spread = halos([f"cuda:{i}" for i in range(4)])
    assert {k: sum(n for (kk, _), n in spread.items() if kk == k)
            for k in chip_smoke.SHARDED_ONLY} == {"halo_exchange_rows": 4, "halo_fill_rows": 16}
