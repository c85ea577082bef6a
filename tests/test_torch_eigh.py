"""The WCT's eigensolver on the CPU: ``sym_eigh``'s plain version (the
kernel's own sweeps) against ``torch.linalg.eigh``, the roots the WCT takes
from it, and the dispatch between the kernel and the library.

The plain version runs in float64 here, where the Jacobi sweeps converge to
the library's answer within a few hundred ulps whatever the spectrum:
random SPD matrices, rank-deficient ones and ones with repeated eigenvalues,
at the 16x cascade's widths (24, 32, 64, 128) and an odd one (127, padded).
The roots compare float32 solvers, the Jacobi sweeps against LAPACK: 1e-4
of the largest entry, as ``test_torch_wct.py`` holds two eigensolvers.
"""

import numpy as np
import pytest
import torch

from collaborative_distillation_tpu_torch.ops import wct_transform as tw
from collaborative_distillation_tpu_torch.ops.cuda import eigh as ke
from collaborative_distillation_tpu_torch.utils.profiling import counters

KINDS = ("spd", "rank_deficient", "repeated")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _matrix(kind: str, n: int, seed: int = 0) -> torch.Tensor:
    """A symmetric (n, n) float64 matrix: X^T X of a tall X ("spd"), of an X
    of rank n // 3 ("rank_deficient"), or Q diag(lam) Q^T with lam taking
    four values ("repeated")."""
    g = torch.Generator().manual_seed(seed)
    if kind == "repeated":
        q, _ = torch.linalg.qr(torch.randn(n, n, generator=g, dtype=torch.float64))
        lam = torch.tensor([0.5, 1.0, 4.0, 4.0], dtype=torch.float64).repeat(n)[:n]
        return (q * lam) @ q.T
    rows = 4 * n + 5 if kind == "spd" else max(n // 3, 1)
    x = torch.randn(rows, n, generator=g, dtype=torch.float64)
    return x.T @ x


def _check_decomposition(a, w, v, sweeps, rel):
    n = a.shape[-1]
    wl = torch.linalg.eigh(a)[0]
    scale = float(wl.abs().max())
    assert float((w - wl).abs().max()) <= rel * scale
    assert float(((v * w[..., None, :]) @ v.mT - a).abs().max()) <= rel * scale
    assert float((v.mT @ v - torch.eye(n, dtype=a.dtype)).abs().max()) <= rel
    assert bool((w[..., 1:] >= w[..., :-1]).all())
    assert int(sweeps.max()) < ke.MAX_SWEEPS


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [24, 32, 64, 128, 127])
def test_sym_eigh_plain_matches_library_in_float64(n, kind):
    a = _matrix(kind, n)[None]
    w, v, sweeps = ke.sym_eigh_plain(a)
    assert (w.shape, v.shape, sweeps.shape, sweeps.dtype) == ((1, n), (1, n, n), (1,),
                                                              torch.int32)
    _check_decomposition(a, w, v, sweeps, 1e-12)


def test_sym_eigh_plain_decomposes_a_stack_each_on_its_own():
    a = torch.stack([_matrix(k, 24, seed=3) for k in KINDS])
    w, v, sweeps = ke.sym_eigh_plain(a)
    for i in range(len(KINDS)):
        one = ke.sym_eigh_plain(a[i:i + 1])
        assert torch.equal(w[i], one[0][0]) and torch.equal(v[i], one[1][0])
        assert int(sweeps[i]) == int(one[2][0])
    _check_decomposition(a, w, v, sweeps, 1e-12)


def test_sym_eigh_plain_reads_the_lower_triangle():
    a = _matrix("spd", 32)
    junk = torch.triu(torch.randn(32, 32, generator=torch.Generator().manual_seed(1),
                                  dtype=torch.float64), 1)
    w, v, _ = ke.sym_eigh_plain((a + junk)[None])
    w0, v0, _ = ke.sym_eigh_plain(a[None])
    assert torch.equal(w, w0) and torch.equal(v, v0)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_sym_eigh_plain_takes_the_smallest_widths(n):
    a = _matrix("spd", n)[None]
    w, v, sweeps = ke.sym_eigh_plain(a)
    _check_decomposition(a, w, v, sweeps, 1e-12)


def test_sym_eigh_plain_stops_after_a_sweep_that_rotates_nothing():
    """A diagonal matrix needs no rotation: one sweep, which finds that."""
    d = torch.diag(torch.tensor([3.0, 1.0, 2.0, 5.0], dtype=torch.float64))[None]
    w, v, sweeps = ke.sym_eigh_plain(d)
    assert w.tolist() == [[1.0, 2.0, 3.0, 5.0]] and int(sweeps[0]) == 1
    assert torch.equal(v[0].abs().sum(0), torch.ones(4, dtype=torch.float64))


@pytest.mark.parametrize("n", [2, 24, 128])
def test_round_robin_meets_every_pair_once_a_sweep(n):
    p, q = ke.round_robin(n)
    assert p.shape == q.shape == (n - 1, n // 2)
    assert bool((p < q).all())
    for r in range(n - 1):   # a round's pairs are disjoint and cover every index
        assert sorted(torch.cat([p[r], q[r]]).tolist()) == list(range(n))
    pairs = {(int(a), int(b)) for a, b in zip(p.flatten(), q.flatten())}
    assert len(pairs) == n * (n - 1) // 2


def test_sym_eigh_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        ke.sym_eigh(torch.zeros(4, 4))
    with pytest.raises(ValueError, match="outside"):
        ke.sym_eigh(torch.zeros(1, 129, 129))
    with pytest.raises(ValueError, match="CUDA"):
        ke.sym_eigh(torch.zeros(2, 8, 8))
    assert ke.sym_eigh.launches == 0 and ke.sym_eigh.plain is ke.sym_eigh_plain


def _f32(kind, n, seed=0):
    return _matrix(kind, n, seed).float()


def _plain_card(monkeypatch):
    """The dispatch as on a card for the stacks of covariances (the maps
    stay on the CPU's plain kernels), with the kernel's plain version
    (float32) standing in for the launch: returns the list of stacks it was
    given."""
    given = []

    def stand_in(a):
        assert a.dtype == torch.float32 and a.is_contiguous()
        given.append(a.shape)
        return ke.sym_eigh_plain(a)
    monkeypatch.setattr(tw, "on_card", lambda x: x.dim() == 3)
    monkeypatch.setattr(tw._keigh, "sym_eigh", stand_in)
    return given


@pytest.mark.parametrize("kind", ["spd", "repeated"])
@pytest.mark.parametrize("n", [24, 64, 128])
def test_roots_on_the_plain_solver_match_the_library(monkeypatch, n, kind):
    cov = _f32(kind, n) / n
    want = tw.matrix_isqrt_sqrt_eigh(cov)
    _plain_card(monkeypatch)
    got = tw.matrix_isqrt_sqrt_eigh(cov)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


def test_rank_deficient_roots_on_the_plain_solver_whiten_the_row_space(monkeypatch):
    """As the library's (test_torch_wct.py's pinned case): rank 6 in 32
    channels, the coloring matrix finite, the row space whitened to ~1, and
    the same whitened data as the library's there."""
    rng = np.random.default_rng(0)
    c, r, p = 32, 6, 4000
    basis = np.linalg.qr(rng.standard_normal((c, r)))[0].astype(np.float32)
    x = (rng.standard_normal((p, r)).astype(np.float32) * 5.0) @ basis.T
    mean, cov = tw.feature_stats(torch.from_numpy(x))
    want = tw.coloring_matrix(cov, torch.eye(c)).numpy()
    _plain_card(monkeypatch)
    t = tw.coloring_matrix(cov, torch.eye(c)).numpy()
    assert np.isfinite(t).all()
    w = (x - mean.numpy()) @ t.T
    lam = np.sort(np.linalg.eigvalsh(w.T @ w / (p - 1)))
    np.testing.assert_allclose(lam[-r:], 1.0, atol=0.1)
    assert lam[:-r].max() < 0.15
    lib = (x - mean.numpy()) @ want.T
    np.testing.assert_allclose(w @ basis, lib @ basis, rtol=1e-3,
                               atol=1e-3 * np.abs(lib @ basis).max())


def test_one_pixel_covariance_poisons_the_roots_on_either_solver(monkeypatch):
    """The 0/0 covariance of a one-pixel map: all-NaN roots and coloring
    matrix, the kernel's path given only finite matrices."""
    _, nan_cov = tw.feature_stats(torch.ones(1, 1, 1, 24))
    assert torch.isnan(nan_cov).all()
    want = tw.coloring_matrix(nan_cov, torch.eye(24))
    given = _plain_card(monkeypatch)
    for got in (*tw.matrix_isqrt_sqrt_eigh(nan_cov), tw.coloring_matrix(nan_cov, torch.eye(24))):
        assert torch.isnan(got).all()
    assert torch.isnan(want).all() and given == [(1, 24, 24), (2, 24, 24)]
    # a finite style beside a poisoned content: only the poisoned root is NaN
    lam, v, poison = tw._eigh(torch.stack([nan_cov, torch.eye(24)]), 1e-8)
    assert torch.isnan(poison[0]) and float(poison[1]) == 1.0
    assert torch.isfinite(lam).all() and torch.isfinite(v).all()


def _delta(before):
    after = counters()
    return {k: after[k] - before[k] for k in ("eigh_kernel", "eigh_library")}


@pytest.mark.parametrize("c, card, want", [
    (32, True, {"eigh_kernel": 2, "eigh_library": 0}),
    (128, True, {"eigh_kernel": 2, "eigh_library": 0}),
    (256, True, {"eigh_kernel": 0, "eigh_library": 2}),
    (32, False, {"eigh_kernel": 0, "eigh_library": 2}),
], ids=["card-32", "card-128", "card-256", "cpu-32"])
def test_dispatch_by_device_and_width(monkeypatch, c, card, want):
    """The card and C <= 128: one launch of the content's and the style's
    covariances; wider, or on the CPU: the library, one matrix a call."""
    given = _plain_card(monkeypatch) if card else []
    calls = []
    library = torch.linalg.eigh

    def counted(a):
        calls.append(a.shape)
        return library(a)
    monkeypatch.setattr(torch.linalg, "eigh", counted)
    cc, sc = _f32("spd", c) / c, _f32("spd", c, seed=1) / c
    before = counters()
    t = tw.coloring_matrix(cc, sc)
    assert _delta(before) == want and torch.isfinite(t).all()
    assert given == ([(2, c, c)] if want["eigh_kernel"] else [])
    assert calls == [(c, c)] * want["eigh_library"]


def test_dispatch_leaves_other_dtypes_to_the_library(monkeypatch):
    given = _plain_card(monkeypatch)
    before = counters()
    tw.matrix_isqrt_sqrt_eigh(_matrix("spd", 16))
    assert _delta(before) == {"eigh_kernel": 0, "eigh_library": 1} and given == []


def test_wct_on_the_plain_solver_matches_the_library(monkeypatch):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 24, 24, 32)).astype(np.float32) + 2.0)
    s = torch.from_numpy(rng.standard_normal((500, 32)).astype(np.float32) * 2.0)
    sm, sc = tw.feature_stats(s)
    want = tw.wct_transform(x, sm, sc, 0.6)
    given = _plain_card(monkeypatch)
    got = tw.wct_transform(x, sm, sc, 0.6)
    assert given == [(2, 32, 32)]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("alpha", [0.6, torch.tensor(0.6), np.float32(0.6)], ids=str)
def test_alpha_stays_a_host_scalar(alpha):
    """A number or a host tensor is an operand of the card's kernels as it
    is (no copy to the card); the blend's arithmetic is float32's."""
    a = tw.alpha_on(alpha, torch.device("cpu"))
    assert a.dtype == torch.float32 and a.device.type == "cpu" and a.dim() == 0
    assert float(1.0 - a) == float(np.float32(1.0) - np.float32(0.6))
