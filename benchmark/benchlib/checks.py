"""The numbers that decide ``correct``, each held to its limit.

Images: ``rms`` is the root mean square of (program - reference) over the
whole image, in units of the [0, 1] range; ``block_rms`` the same over the
worst 64x64 block, which a fault confined to a seam, a slab or a tile
cannot hide in. Training (each gap taken by the worst leaf, against the
reference's norm of that leaf or of the median leaf, whichever is larger):
``loss_gap`` the largest relative gap of a loss term over the compared
steps; ``grad_gap`` the gap of the first gradient's norm, read from the
program's Adam state after one step (exp_avg = (1 - beta1) g);
``update_gap`` the gap of the norm of the parameters' change over the
compared steps, over the leaves whose first gradient in the reference is at
least a thousandth of the median leaf's."""

from __future__ import annotations

import math
import statistics

BLOCK = 64


def image_gaps(torch, out, ref) -> dict:
    """``out``, ``ref``: (H, W, 3), or a batch of one, on one device."""
    import torch.nn.functional as F
    d2 = (out.float().reshape(ref.shape[-3:]) - ref.float().reshape(ref.shape[-3:])).square_()
    rms = float(d2.mean().sqrt())
    blocks = F.avg_pool2d(d2.permute(2, 0, 1)[None], BLOCK, ceil_mode=True).mean(1)
    return {"rms": rms, "block_rms": float(blocks.max().sqrt())}


def _norms(tree) -> dict:
    return {(n, k): float(t.float().norm()) for n, leaf in tree.items() for k, t in leaf.items()}


def _gap(prog: dict, ref: dict, keys) -> float:
    floor = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in keys)


def train_gaps(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``{"losses": [{term: float}] a step, "grad1",
    "delta"}`` with trees ``{layer: {"w", "b"}}``."""
    loss = max(abs(p[t] - r[t]) / max(abs(r[t]), 1e-30)
               for p, r in zip(prog["losses"], ref["losses"]) for t in r)
    g_p, g_r = _norms(prog["grad1"]), _norms(ref["grad1"])
    g_floor = statistics.median(g_r.values())
    moved = [k for k in g_r if g_r[k] >= 1e-3 * g_floor]
    return {"loss_gap": loss, "grad_gap": _gap(g_p, g_r, list(g_r)),
            "update_gap": _gap(_norms(prog["delta"]), _norms(ref["delta"]), moved)}


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(every number finite and within its limit, [{name, value, limit}])."""
    rows = [{"name": n, "value": numbers.get(n), "limit": lim} for n, lim in limits.items()]
    ok = all(r["value"] is not None and math.isfinite(r["value"]) and r["value"] <= r["limit"]
             for r in rows)
    return ok, rows
