"""MobileNetV1 WCT encoders and checkpoint conversion.

The reference ships ``tools/convert_original_mobilenet_to_mine.py``, a
converter from a stock MobileNetV1 classifier checkpoint to five truncated
``Encoder{1..5}`` feature extractors; the ``model_MobileNet`` module it
imports was never committed, so the tool is dead code upstream. This module
is the working equivalent: the architecture comes from the converter's own
tensor maps (convert_original_mobilenet_to_mine.py:11-49), which index the
standard MobileNetV1 backbone (``model.0`` = 3x3 conv+BN, ``model.1..8`` =
depthwise-separable blocks with sub-indices 0/1 = dw conv/BN and 3/4 = pw
conv/BN) and cut it at five tap points:

=======  =======================  ========  ===========
encoder  last layer (ref name)    channels  cum. stride
=======  =======================  ========  ===========
1        ``bn11``  (model.0 BN)   32        2
2        ``bn31``  (model.2 dw)   64        4
3        ``bn51``  (model.4 dw)   128       8
4        ``bn71``  (model.6 dw)   256       16
5        ``bn91``  (model.8 dw)   512       16
=======  =======================  ========  ===========

BatchNorm is folded into the convs at conversion, so the parameters are the
flat ``{name: {"w": HWIO, "b": (C,)}}`` tree of every other family here,
depthwise weights HWIO with I = 1. Each cut ends on a BN that MobileNetV1
follows with a ReLU, and WCT taps are ReLU features, so the encoders end
with ReLU. The tables and the conversion are numpy; the forward is
``F.conv2d`` (the reference leaves it to XLA, not a Pallas kernel), in full
float32 on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.precision import full_float32

__all__ = [
    "MOBILENET_BLOCKS",
    "mobilenet_layer_table",
    "MOBILENET_TAP_WIDTHS",
    "fold_batchnorm",
    "convert_mobilenet_state_dict",
    "apply_mobilenet_encoder",
    "mobilenet_param_shapes",
]

# Standard MobileNetV1 backbone, blocks 0..8 — all the reference tensor maps
# reach. (cin, cout, stride); block 0 is the full 3x3 conv, blocks >= 1 are
# depthwise-separable (3x3 dw stride s on cin, then 1x1 pw cin -> cout).
MOBILENET_BLOCKS: list[tuple[int, int, int]] = [
    (3, 32, 2),      # model.0  conv_bn
    (32, 64, 1),     # model.1  conv_dw
    (64, 128, 2),    # model.2
    (128, 128, 1),   # model.3
    (128, 256, 2),   # model.4
    (256, 256, 1),   # model.5
    (256, 512, 2),   # model.6
    (512, 512, 1),   # model.7
    (512, 512, 1),   # model.8
]

# Encoder stage -> index of the last (block, part) included, matching the
# reference tensor maps: stage 1 stops after model.0's BN, stages 2..5 stop
# after the DEPTHWISE BN of blocks 2/4/6/8 (the pw half of the final block
# is not part of the encoder).
_STAGE_END: dict[int, tuple[int, str]] = {
    1: (0, "std"),
    2: (2, "dw"),
    3: (4, "dw"),
    4: (6, "dw"),
    5: (8, "dw"),
}

MOBILENET_TAP_WIDTHS = [32, 64, 128, 256, 512]


def mobilenet_layer_table(stage: int) -> list[dict]:
    """Ordered layer list for encoder ``stage``.

    Each entry: ``{"name", "kind" ("std"|"dw"|"pw"), "block", "cin",
    "cout", "stride"}``. Names follow the reference converter's scheme
    (conv_original_mobilenet_to_mine.py:11-21): row r = block r-1,
    ``conv{r}1`` = the block's full/dw conv, ``conv{r}2`` = its pw conv.
    """
    if stage not in _STAGE_END:
        raise ValueError(f"stage must be 1..5, got {stage}")
    end_block, end_part = _STAGE_END[stage]
    table: list[dict] = []
    for b, (cin, cout, stride) in enumerate(MOBILENET_BLOCKS):
        if b > end_block:
            break
        r = b + 1
        if b == 0:
            table.append({"name": f"conv{r}1", "kind": "std", "block": b,
                          "cin": cin, "cout": cout, "stride": stride})
            continue
        table.append({"name": f"conv{r}1", "kind": "dw", "block": b,
                      "cin": cin, "cout": cin, "stride": stride})
        if b == end_block and end_part == "dw":
            break
        table.append({"name": f"conv{r}2", "kind": "pw", "block": b,
                      "cin": cin, "cout": cout, "stride": 1})
    return table


def mobilenet_param_shapes(stage: int) -> dict[str, tuple[tuple[int, ...], tuple[int]]]:
    """name -> (folded HWIO weight shape, bias shape) for ``stage``."""
    shapes = {}
    for l in mobilenet_layer_table(stage):
        if l["kind"] == "std":
            w = (3, 3, l["cin"], l["cout"])
        elif l["kind"] == "dw":
            w = (3, 3, 1, l["cout"])
        else:
            w = (1, 1, l["cin"], l["cout"])
        shapes[l["name"]] = (w, (l["cout"],))
    return shapes


def fold_batchnorm(w: np.ndarray, gamma: np.ndarray, beta: np.ndarray,
                   mean: np.ndarray, var: np.ndarray,
                   eps: float = 1e-5) -> tuple[np.ndarray, np.ndarray]:
    """Fold an inference BN (scale gamma, shift beta, running mean/var) into
    the preceding bias-free conv: returns (w', b') with
    ``w' = w * gamma/sqrt(var+eps)`` (per output channel, HWIO minor) and
    ``b' = beta - mean * gamma/sqrt(var+eps)``."""
    scale = gamma / np.sqrt(var + eps)
    return (w * scale[None, None, None, :]).astype(np.float32), \
        (beta - mean * scale).astype(np.float32)


def _strip_prefix(key: str) -> str:
    for pre in ("module.model.", "model."):
        if key.startswith(pre):
            return key[len(pre):]
    return key


def convert_mobilenet_state_dict(state_dict, stage: int, *,
                                 eps: float = 1e-5) -> dict[str, dict[str, np.ndarray]]:
    """Stock MobileNetV1 state dict -> folded param tree for encoder ``stage``.

    Accepts the reference converter's input format
    (convert_original_mobilenet_to_mine.py:52-53): keys
    ``module.model.<block>.<sub>.{weight,bias,running_mean,running_var}``
    where sub 0/1 = (dw or full) conv/BN and sub 3/4 = pw conv/BN. Conv
    weights are torch OIHW; depthwise weights OIHW with I=1 (groups=cin).
    BN is folded (see :func:`fold_batchnorm`); output tree is the
    framework-native ``{name: {"w": HWIO, "b": (C,)}}``.
    """
    flat = {}
    for key, val in state_dict.items():
        arr = val.numpy() if hasattr(val, "numpy") else np.asarray(val)
        flat[_strip_prefix(key)] = np.asarray(arr, dtype=np.float32)

    def get(block: int, sub: int, field: str) -> np.ndarray:
        key = f"{block}.{sub}.{field}"
        if key not in flat:
            raise KeyError(
                f"MobileNet checkpoint missing {key!r} (after stripping "
                f"'module.model.'); have e.g. {sorted(flat)[:4]}")
        return flat[key]

    tree: dict[str, dict[str, np.ndarray]] = {}
    for l in mobilenet_layer_table(stage):
        sub = 0 if l["kind"] in ("std", "dw") else 3
        w = get(l["block"], sub, "weight")           # OIHW
        if l["kind"] == "dw":
            if w.shape[1] != 1:
                raise ValueError(
                    f"{l['name']}: expected depthwise OIHW weight with I=1, "
                    f"got {w.shape}")
        w = np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # -> HWIO
        wf, bf = fold_batchnorm(
            w,
            get(l["block"], sub + 1, "weight"),
            get(l["block"], sub + 1, "bias"),
            get(l["block"], sub + 1, "running_mean"),
            get(l["block"], sub + 1, "running_var"),
            eps=eps,
        )
        tree[l["name"]] = {"w": wf, "b": bf}
    return tree


def apply_mobilenet_encoder(params, x: torch.Tensor, stage: int) -> dict[str, torch.Tensor]:
    """Run MobileNet encoder ``stage`` on an NHWC map; returns named features.

    Keys: ``out`` (the last ReLU) and ``relu{k}`` at every lower stage's tap
    point, the multi-tap shape of :func:`..models.vgg.apply_encoder`.
    ``params``: the folded tree, tensors or arrays (moved to ``x``'s device).
    3x3 convs take an explicit (1, 1) zero pad, as torch ``Conv2d(padding=1)``
    at every stride (MobileNet was trained with zero padding, unlike the VGG
    WCT stack's reflect padding); depthwise ones are grouped convs.
    """
    tap_last = {mobilenet_layer_table(s)[-1]["name"]: f"relu{s}" for s in range(1, stage + 1)}
    outs: dict[str, torch.Tensor] = {}
    h = x.permute(0, 3, 1, 2)
    with full_float32():
        for l in mobilenet_layer_table(stage):
            p = params[l["name"]]
            w = torch.as_tensor(p["w"]).to(x.device, x.dtype).permute(3, 2, 0, 1)
            b = torch.as_tensor(p["b"]).to(x.device, x.dtype)
            h = torch.relu(F.conv2d(h, w, b, stride=l["stride"],
                                    padding=0 if l["kind"] == "pw" else 1,
                                    groups=l["cin"] if l["kind"] == "dw" else 1))
            name = tap_last.get(l["name"])
            if name:
                outs[name] = h.permute(0, 2, 3, 1).contiguous()
    outs["out"] = outs[f"relu{stage}"]
    return outs
