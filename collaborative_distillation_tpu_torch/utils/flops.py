"""Analytic FLOP counts for the WCT cascade, and the card's peak: the
denominator of a whole-cascade utilization figure.

The counters walk the same :class:`~..models.specs.StageSpec` tables the
engine runs (reference architecture: model/model_original.py:11-619,
model_cd.py:62-848), so the count and the compute graph cannot drift apart.

Conventions: 1 MAC = 2 FLOPs; bias adds and ReLUs are counted (h*w*out
each, < 0.1 % of the total); pools, upsamples and pads are bytes, not
FLOPs, and are left out, so the utilization is a product-utilization figure.
"""

from __future__ import annotations

import torch

from ..models.specs import StageSpec, decoder_spec, encoder_spec

__all__ = ["stage_flops", "cascade_flops", "card_peak_flops", "CARD_PEAKS"]


def stage_flops(spec: StageSpec, h: int, w: int, *, include_aux: bool = False) -> float:
    """FLOPs for one encoder or decoder stage applied to an (h, w) input.

    The resolution follows the spec as the apply functions run it: encoder
    pools halve after the flagged layer, decoder upsamples double after
    theirs.
    """
    total = 0.0
    if spec.has_conv0:  # fixed 1x1 RGB preconditioning conv
        total += h * w * (2 * 1 * 1 * 3 + 2) * 3
    for l in spec.layers:
        total += h * w * (2 * l.kernel * l.kernel * l.in_ch + 2) * l.out_ch
        if include_aux:
            for a in spec.aux:
                # encoder adapters are "conv{k}1_aux", decoder ones "aux{k}1";
                # both hang off layer conv{k}1 at that layer's output size
                if a.name in (l.name + "_aux", "aux" + l.name[4:]):
                    total += h * w * (2 * a.in_ch + 2) * a.out_ch
        if l.pool_after:
            h, w = h // 2, w // 2
        if l.unpool_after:
            h, w = h * 2, w * 2
    return total


def _wct_flops(c: int, hw: int) -> float:
    """The WCT transform at one stage: the content covariance (c x c over hw
    samples), whitening and colouring folded into one c x c apply, and the
    O(c^3) eigendecomposition (~25 c^3 with the two c x c rebuild products).
    The style's statistics are cached per style and left out, as a server's
    steady state."""
    cov = 2.0 * c * c * hw
    apply_ = 2.0 * c * c * hw
    eig = 25.0 * c ** 3
    return cov + apply_ + eig


def cascade_flops(mode: str, h: int, w: int, stages=(5, 4, 3, 2, 1)) -> float:
    """Total FLOPs of the multi-stage cascade at (h, w).

    Each stage encodes the previous stage's full-resolution output again
    (WCT.py:120-125: the cascade is sequential by design), so the stages'
    costs add up. Inference encoders do not run the 1x1 aux adapters."""
    h, w = -(-h // 16) * 16, -(-w // 16) * 16  # the engine pads to 16
    total = 0.0
    for k in stages:
        es, ds = encoder_spec(mode, k), decoder_spec(mode, k)
        total += stage_flops(es, h, w) + stage_flops(ds, h >> (k - 1), w >> (k - 1))
        total += _wct_flops(es.out_channels, (h >> (k - 1)) * (w >> (k - 1)))
    return total


# Dense peak FLOP/s by the type of the operands, from NVIDIA's public data
# sheet (without sparsity), keyed by a tag of the card's lower-cased name:
# the H100 SXM5 part, whose name is "NVIDIA H100 80GB HBM3". float32 is the
# CUDA cores' FFMA rate, the others the tensor cores'.
CARD_PEAKS = {
    "h100 80gb hbm3": {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
                       "float16": 989e12},
}

_DTYPES = {"float32": "float32", "f32": "float32", "tf32": "tf32", "bfloat16": "bfloat16",
           "bf16": "bfloat16", "float16": "float16", "fp16": "float16"}


def card_peak_flops(device=0, dtype: str = "float32") -> tuple[float, str]:
    """(peak FLOP/s, label) of a card for operands of ``dtype``, or (0,
    name) where the card is not in :data:`CARD_PEAKS`: callers then report
    raw FLOP/s and no share of peak. ``device``: a CUDA device (index,
    ``torch.device`` or ``"cuda:N"``), or the card's name as
    ``torch.cuda.get_device_name`` gives it."""
    if dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; one of {sorted(_DTYPES)}")
    name = device if isinstance(device, str) and not device.startswith("cuda") else \
        torch.cuda.get_device_name(device)
    for tag, peaks in CARD_PEAKS.items():
        if tag in name.lower():
            return peaks[_DTYPES[dtype]], f"{tag}:{_DTYPES[dtype]}"
    return 0.0, name
