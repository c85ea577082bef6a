"""The layer tables of the WCT VGG-19 pyramid, from a configuration's
widths: the encoder of stage k runs conv0 (a fixed 1x1: RGB -> BGR x 255 -
the Caffe mean) and the VGG-19 convs through conv{k}1, a 2x2 max pool after
conv12, conv22, conv34 and conv44; the decoder mirrors it, a nearest 2x
upsample after each conv{j}1 with j >= 2, a ReLU after every 3x3 conv
(model_original.py, model_cd.py)."""

from __future__ import annotations

import dataclasses

ENC_ORDER = ["conv11", "conv12", "conv21", "conv22", "conv31", "conv32", "conv33", "conv34",
             "conv41", "conv42", "conv43", "conv44", "conv51"]
POOL_AFTER = {"conv12", "conv22", "conv34", "conv44"}
TAPS = ["conv11", "conv21", "conv31", "conv41", "conv51"]
# the preprocessing conv0 of every encoder, HWIO (model_original.py:428-433)
CONV0_W = [[[[0.0, 0.0, 255.0], [0.0, 255.0, 0.0], [255.0, 0.0, 0.0]]]]
CONV0_B = [-103.939, -116.779, -123.68]


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    cin: int
    cout: int
    kernel: int = 3
    relu: bool = True
    pool: bool = False    # a 2x2 max pool after it
    up: bool = False      # a nearest 2x upsample after it
    tap: bool = False     # its output is a relu{j}1 tap


def widths(cfg: dict, stage: int) -> dict:
    w = dict(cfg["widths"])
    w.update(cfg.get("stage_widths", {}).get(str(stage), {}))
    return w


def encoder(cfg: dict, stage: int) -> list[Layer]:
    w = widths(cfg, stage)
    layers, cin = [], 3
    for name in ENC_ORDER:
        last = name == f"conv{stage}1"
        layers.append(Layer(name, cin, w[name], pool=name in POOL_AFTER and not last,
                            tap=name in TAPS))
        cin = w[name]
        if last:
            return layers
    raise ValueError(f"stage {stage} is not in 1..5")


def decoder(cfg: dict, stage: int) -> list[Layer]:
    return [Layer(l.name, l.cout, l.cin, up=l.tap and int(l.name[4]) >= 2)
            for l in reversed(encoder(cfg, stage))]


def aux(cfg: dict, stage: int) -> list[Layer]:
    """The student encoder's 1x1 adapters conv{j}1_aux, tap j -> teacher width."""
    w = widths(cfg, stage)
    return [Layer(f"conv{j}1_aux", w[f"conv{j}1"], cfg["aux_widths"][j - 1], kernel=1,
                  relu=False) for j in range(1, stage + 1)]


def param_shapes(layers: list[Layer], *, conv0: bool) -> dict:
    """name -> ((kh, kw, cin, cout), (cout,)), HWIO as the weight files hold them."""
    shapes = {"conv0": ((1, 1, 3, 3), (3,))} if conv0 else {}
    for l in layers:
        shapes[l.name] = ((l.kernel, l.kernel, l.cin, l.cout), (l.cout,))
    return shapes
