"""Batched symmetric eigensolver: the ``sym_eigh`` kernel and its plain version.

The kernel (``csrc/eigh.cu``) replaces no TPU kernel: the reference takes
the WCT's roots from ``jnp.linalg.eigh``. It exists so that a WCT on the
card decomposes its covariances without the host waiting for the card,
which ``torch.linalg.eigh`` (cuSOLVER) does at every call. Parallel cyclic
Jacobi, one block a matrix, the matrix and its eigenvectors in shared
memory; it stops where a sweep rotates nothing, decided on the card.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .conv import _check_cuda

__all__ = ["MAX_N", "MAX_SWEEPS", "round_robin", "sym_eigh_plain", "sym_eigh"]

MAX_N = 128        # A and V of one matrix fit in one block's shared memory
MAX_SWEEPS = 30    # the WCT's float32 covariances take 8 to 10 (PERF.md §6)


@functools.lru_cache(maxsize=16)
def round_robin(n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(p, q)``, each (n - 1, n / 2) int64 for an even ``n``: the pairs of
    each round of one sweep, p < q, in the kernel's order of rounds and
    pairs (the circle method: every pair of indices meets once a sweep, the
    pairs of a round are disjoint)."""
    k = torch.arange(n // 2)
    r = torch.arange(n - 1)[:, None]
    x = torch.where(k == 0, 0, 1 + (k - 1 + r) % (n - 1))
    y = 1 + (n - 2 - k + r) % (n - 1)
    return torch.minimum(x, y), torch.maximum(x, y)


def sym_eigh_plain(a: torch.Tensor):
    """Plain version: the kernel's sweeps on a (B, n, n) stack (its lower
    triangle, as ``torch.linalg.eigh`` reads it) in ``a``'s dtype, the skip
    tolerance that dtype's epsilon. Returns ``(w (B, n) ascending, v (B, n,
    n) with the eigenvectors as columns, sweeps (B,) int32)``."""
    b, n, _ = a.shape
    np_ = n + n % 2
    tol = torch.finfo(a.dtype).eps
    low = torch.tril(a)
    m = a.new_zeros(b, np_, np_)
    m[:, :n, :n] = low + torch.tril(low, -1).mT
    v = torch.eye(np_, dtype=a.dtype, device=a.device).repeat(b, 1, 1)
    sweeps = torch.zeros(b, dtype=torch.int32, device=a.device)
    active = torch.ones(b, dtype=torch.bool, device=a.device)
    rows = torch.arange(b, device=a.device)[:, None]
    pp, qq = round_robin(np_)
    for _ in range(MAX_SWEEPS):
        sweeps += active.to(torch.int32)
        rotated = torch.zeros(b, dtype=torch.bool, device=a.device)
        for p, q in zip(pp.to(a.device), qq.to(a.device)):
            app, aqq, apq = m[:, p, p], m[:, q, q], m[:, p, q]
            rot = (apq.abs() > tol * app.abs().sqrt() * aqq.abs().sqrt()) & active[:, None]
            theta = (aqq - app) / (2 * torch.where(rot, apq, 1.0))
            t = torch.where(
                theta.abs() > 1e18, 0.5 / theta,
                torch.copysign(1 / (theta.abs() + torch.sqrt(theta * theta + 1)), theta))
            t = torch.where(rot, t, 0.0)
            c = 1 / torch.sqrt(t * t + 1)
            s = t * c
            cr, sr = c[..., None], s[..., None]     # by rows
            cc, sc = c[:, None, :], s[:, None, :]   # by columns
            mp, mq = m[:, p, :], m[:, q, :]
            m[:, p, :], m[:, q, :] = cr * mp - sr * mq, sr * mp + cr * mq
            mp, mq = m[:, :, p], m[:, :, q]
            m[:, :, p], m[:, :, q] = cc * mp - sc * mq, sc * mp + cc * mq
            vp, vq = v[:, :, p], v[:, :, q]
            v[:, :, p], v[:, :, q] = cc * vp - sc * vq, sc * vp + cc * vq
            # each pair's own block exactly, as the kernel writes it
            m[rows, p, p] = torch.where(rot, app - t * apq, m[rows, p, p])
            m[rows, q, q] = torch.where(rot, aqq + t * apq, m[rows, q, q])
            m[rows, p, q] = torch.where(rot, 0.0, m[rows, p, q])
            m[rows, q, p] = torch.where(rot, 0.0, m[rows, q, p])
            rotated |= rot.any(1)
        active &= rotated
        if not bool(active.any()):
            break
    w = torch.diagonal(m, dim1=1, dim2=2)[:, :n]
    w, order = torch.sort(w, dim=1, stable=True)
    v = torch.take_along_dim(v[:, :n, :n], order[:, None, :], dim=2)
    return w, v, sweeps


def sym_eigh(a: torch.Tensor):
    """Launch the kernel on a contiguous float32 (B, n, n) stack of symmetric
    matrices on one CUDA device, n <= 128 (its lower triangle is read), one
    block a matrix: ``(w (B, n) ascending, v (B, n, n), sweeps (B,) int32)``
    as :func:`sym_eigh_plain` gives them, all on the card; the host waits
    for nothing. The caller gives finite matrices."""
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"sym_eigh: needs (B, n, n), got {tuple(a.shape)}")
    b, n, _ = a.shape
    if not 1 <= n <= MAX_N or b < 1:
        raise ValueError(f"sym_eigh: (B, n) = {(b, n)} outside B >= 1, n in 1..{MAX_N}")
    _check_cuda("sym_eigh", a)
    w = torch.empty((b, n), device=a.device, dtype=torch.float32)
    v = torch.empty((b, n, n), device=a.device, dtype=torch.float32)
    sweeps = torch.empty(b, device=a.device, dtype=torch.int32)
    lib = _build.library()
    with torch.cuda.device(a.device):
        err = lib.cd_sym_eigh(a.data_ptr(), w.data_ptr(), v.data_ptr(), sweeps.data_ptr(), b, n,
                              MAX_SWEEPS, torch.finfo(torch.float32).eps,
                              torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sym_eigh")
    sym_eigh.launches += 1
    return w, v, sweeps


sym_eigh.launches = 0
sym_eigh.plain = sym_eigh_plain
