"""The input maker: every image a cell uses, made on the device from the
seed and the repository's 512x512 photo pair (``data/photo_pair_512.npz``).

A stylization image is the photo mirror-tiled to the cell's size from a
seeded offset, with seeded flips; a training row is a seeded 256x256 crop,
flipped or not, of one photo resized to a shorter side of 300 (the
reference's training crops). The same seed gives the same images; every
seed gives images of the same sizes."""

from __future__ import annotations

import os
import random

import numpy as np

from .weights import sub_seed


def rng(seed: int, tag: str) -> random.Random:
    return random.Random(sub_seed(seed, tag))


def photo_pair(torch, bench_dir: str, device):
    with np.load(os.path.join(bench_dir, "data", "photo_pair_512.npz")) as d:
        return (torch.tensor(d["content"], device=device),
                torch.tensor(d["style"], device=device))


def _mirror(torch, n_out: int, n_src: int, offset: int, flip: bool, device):
    """Indices that tile ``n_src`` rows to ``n_out``, mirrored at each edge."""
    period = 2 * n_src
    j = (torch.arange(n_out, device=device) + offset) % period
    idx = torch.where(j < n_src, j, period - 1 - j)
    return n_src - 1 - idx if flip else idx


def tiled(torch, src, hw, r: random.Random):
    """``src`` (h, w, 3) uint8 tiled to ``hw`` from a seeded offset and flips:
    (H, W, 3) uint8 on ``src``'s device."""
    h, w = src.shape[:2]
    iy = _mirror(torch, hw[0], h, r.randrange(2 * h), r.random() < 0.5, src.device)
    ix = _mirror(torch, hw[1], w, r.randrange(2 * w), r.random() < 0.5, src.device)
    return src.index_select(0, iy).index_select(1, ix).contiguous()


def stylize_ring(torch, bench_dir: str, mix: dict, seed: int, device, *, uint8=False):
    """``mix["ring"]`` distinct (content, style) pairs: float (H, W, 3) in [0, 1]
    on ``device``, or with ``uint8`` host uint8 arrays."""
    content, style = photo_pair(torch, bench_dir, device)
    r = rng(seed, "ring")
    ring = []
    for _ in range(mix["ring"]):
        pair = (tiled(torch, content, mix["content_hw"], r),
                tiled(torch, style, mix["style_hw"], r))
        if uint8:
            ring.append(tuple(np.ascontiguousarray(p.cpu().numpy()) for p in pair))
        else:
            ring.append(tuple(p.float().div_(255.0) for p in pair))
    return ring


def train_ring(torch, bench_dir: str, mix: dict, seed: int, device):
    """``mix["ring"]`` batches of ``mix["batch"]`` distinct crops, float
    (N, crop, crop, 3) in [0, 1] on ``device``."""
    import torch.nn.functional as F
    side, crop = mix["shorter_side"], mix["crop"]
    photos = [F.interpolate(p.permute(2, 0, 1)[None].float(), size=(side, side),
                            mode="bilinear", antialias=True, align_corners=False)[0]
              .permute(1, 2, 0).clamp_(0, 255).div_(255.0)
              for p in photo_pair(torch, bench_dir, device)]
    r = rng(seed, "train")
    batches, seen = [], set()
    for _ in range(mix["ring"]):
        rows = []
        while len(rows) < mix["batch"]:
            key = (r.randrange(2), r.randrange(side - crop + 1), r.randrange(side - crop + 1),
                   r.random() < 0.5)
            if key in seen:
                continue
            seen.add(key)
            src, y, x, flip = key
            row = photos[src][y:y + crop, x:x + crop]
            rows.append(row.flip(1) if flip else row)
        batches.append(torch.stack(rows).contiguous())
    return batches


def sample(seed: int, n_items: int, k: int, tag: str = "sample") -> list[int]:
    """``k`` distinct item indices in [0, n_items), drawn from the seed."""
    return sorted(rng(seed, tag).sample(range(n_items), min(k, n_items)))
