"""Declarative architecture specs for the WCT VGG-19 autoencoder pyramid.

The reference hand-unrolls 30 nearly-identical nn.Module classes
(model/model_original.py, model/model_cd.py, model/model_kd2sd.py, ~1800 LoC).
Here the whole model zoo is three width tables plus two generators; the apply
functions in :mod:`..models.vgg` interpret these specs.

Families
--------
* ``original``  — unpruned VGG-19 teacher (Encoder1..5 / Decoder1..5,
  model_original.py:11-619).
* ``16x``       — 16x-compressed students (SmallEncoder{1..5}_16x_aux /
  SmallDecoder{1..5}_16x, model_cd.py:62-848). Stage-1 encoder/decoder use
  width 24 for conv11 (model_cd.py:324); all encoders carry 1x1 aux adapters
  back to teacher tap widths.
* Decoder aux (kd2sd) adapters (model_kd2sd.py:31-34) are generated by
  :func:`decoder_spec` with ``aux=True``.

Layer naming follows the reference state-dict keys (``conv11`` .. ``conv51``,
``conv0``, ``conv11_aux`` .., ``aux21`` ..) so converted checkpoints map 1:1.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "ConvLayer",
    "StageSpec",
    "encoder_spec",
    "decoder_spec",
    "TEACHER_WIDTHS",
    "STUDENT_WIDTHS",
    "TAP_LAYERS",
    "TEACHER_TAP_WIDTHS",
]

# conv name -> output width, in VGG-19 forward order (through relu5_1).
TEACHER_WIDTHS = {
    "conv11": 64, "conv12": 64,
    "conv21": 128, "conv22": 128,
    "conv31": 256, "conv32": 256, "conv33": 256, "conv34": 256,
    "conv41": 512, "conv42": 512, "conv43": 512, "conv44": 512,
    "conv51": 512,
}

# 16x-pruned student widths (model_cd.py SmallEncoder5_16x_aux.__init__).
STUDENT_WIDTHS = {
    "conv11": 16, "conv12": 16,
    "conv21": 32, "conv22": 32,
    "conv31": 64, "conv32": 64, "conv33": 64, "conv34": 64,
    "conv41": 128, "conv42": 128, "conv43": 128, "conv44": 128,
    "conv51": 128,
}

# Forward order of encoder conv layers; pools sit after conv12/22/34/44.
_ENC_ORDER = [
    "conv11", "conv12",
    "conv21", "conv22",
    "conv31", "conv32", "conv33", "conv34",
    "conv41", "conv42", "conv43", "conv44",
    "conv51",
]
_POOL_AFTER = {"conv12", "conv22", "conv34", "conv44"}

# relu{k}_1 tap layers, k = 1..5.
TAP_LAYERS = ["conv11", "conv21", "conv31", "conv41", "conv51"]
TEACHER_TAP_WIDTHS = [64, 128, 256, 512, 512]


@dataclass(frozen=True)
class ConvLayer:
    name: str            # state-dict key, e.g. "conv21" / "conv21_aux" / "aux21"
    in_ch: int
    out_ch: int
    kernel: int = 3      # 3 => reflect-pad(1) + 3x3; 1 => plain 1x1
    relu: bool = True
    pool_after: bool = False     # encoder: 2x2 max pool after this layer
    unpool_after: bool = False   # decoder: nearest 2x upsample after this layer
    tap: str | None = None       # tap name exposed in the outputs dict


@dataclass(frozen=True)
class StageSpec:
    """A fully-resolved encoder or decoder stage."""
    kind: str                 # "encoder" | "decoder"
    family: str               # "original" | "16x"
    stage: int                # 1..5
    layers: tuple[ConvLayer, ...]
    aux: tuple[ConvLayer, ...] = field(default_factory=tuple)  # 1x1 adapters, keyed by source tap
    has_conv0: bool = False   # fixed 1x1 RGB preprocessing conv (encoders)

    @property
    def out_channels(self) -> int:
        return self.layers[-1].out_ch

    def param_shapes(self) -> dict[str, tuple[tuple[int, int, int, int], tuple[int]]]:
        """name -> ((kh, kw, in, out), (out,)) for every conv incl. conv0/aux."""
        shapes = {}
        if self.has_conv0:
            shapes["conv0"] = ((1, 1, 3, 3), (3,))
        for l in self.layers + self.aux:
            k = l.kernel
            shapes[l.name] = ((k, k, l.in_ch, l.out_ch), (l.out_ch,))
        return shapes


def _widths(family: str, stage: int) -> dict[str, int]:
    if family == "original":
        return TEACHER_WIDTHS
    if family == "16x":
        w = dict(STUDENT_WIDTHS)
        if stage == 1:
            w["conv11"] = 24  # model_cd.py:324 — stage-1 student keeps 24 filters
        return w
    raise ValueError(f"unknown family {family!r} (expected 'original' or '16x')")


def encoder_spec(family: str, stage: int, *, aux: bool = False) -> StageSpec:
    """Encoder stage ``k``: conv0 then VGG-19 layers through relu{k}_1.

    ``aux=True`` adds the student's 1x1 ``conv{j}1_aux`` adapters mapping each
    tap back to teacher width (model_cd.py:704-708); only valid for ``16x``.
    """
    if not 1 <= stage <= 5:
        raise ValueError(f"stage must be 1..5, got {stage}")
    w = _widths(family, stage)
    last = f"conv{stage}1"
    layers: list[ConvLayer] = []
    in_ch = 3
    for name in _ENC_ORDER:
        is_last = name == last
        tap = f"relu{name[4]}1" if name in TAP_LAYERS else None
        layers.append(ConvLayer(
            name=name, in_ch=in_ch, out_ch=w[name], kernel=3, relu=True,
            pool_after=(name in _POOL_AFTER) and not is_last, tap=tap,
        ))
        in_ch = w[name]
        if is_last:
            break
    aux_layers: list[ConvLayer] = []
    if aux:
        if family != "16x":
            raise ValueError("aux adapters only exist for the 16x student family")
        for k in range(1, stage + 1):
            src = f"conv{k}1"
            aux_layers.append(ConvLayer(
                name=f"{src}_aux", in_ch=w[src], out_ch=TEACHER_TAP_WIDTHS[k - 1],
                kernel=1, relu=False, tap=f"aux{k}1",
            ))
    return StageSpec("encoder", family, stage, tuple(layers), tuple(aux_layers), has_conv0=True)


def decoder_spec(family: str, stage: int, *, aux: bool = False) -> StageSpec:
    """Decoder stage ``k``: mirror of the encoder, conv{k}1 .. conv11, nearest
    2x upsample after each conv{j}1 (j >= 2), ReLU on every conv including the
    final conv11 (model_original.py:581-599, model_cd.py:276-293).

    ``aux=True`` adds the kd2sd 1x1 ``aux{j}1`` adapters on the *unpooled*
    conv{j}1 features (model_kd2sd.py:72-102); only valid for ``16x``.
    """
    if not 1 <= stage <= 5:
        raise ValueError(f"stage must be 1..5, got {stage}")
    w = _widths(family, stage)
    tw = _widths("original", stage)
    enc_names = []
    for name in _ENC_ORDER:
        enc_names.append(name)
        if name == f"conv{stage}1":
            break
    # Decoder input width of layer `name` = encoder output width of `name`;
    # output width = encoder input width of `name`.
    enc_in = {}
    in_ch = 3
    for name in enc_names:
        enc_in[name] = in_ch
        in_ch = w[name]
    layers: list[ConvLayer] = []
    for name in reversed(enc_names):
        k = int(name[4])
        is_k1 = name.endswith("1") and len(name) == 6 and name[5] == "1"
        tap = f"dec{k}1" if name in TAP_LAYERS else None
        layers.append(ConvLayer(
            name=name, in_ch=w[name], out_ch=enc_in[name], kernel=3, relu=True,
            unpool_after=(name in TAP_LAYERS) and k >= 2, tap=tap,
        ))
    aux_layers: list[ConvLayer] = []
    if aux:
        if family != "16x":
            raise ValueError("decoder aux adapters only exist for the 16x family")
        # teacher decoder tap widths: output width of teacher conv{k}1 as a
        # *decoder* layer = teacher encoder input width of conv{k}1.
        t_enc_in = {}
        t_in = 3
        for name in enc_names:
            t_enc_in[name] = t_in
            t_in = tw[name]
        for name in reversed(enc_names):
            if name not in TAP_LAYERS:
                continue
            k = int(name[4])
            if k < 2:
                continue  # no aux11 (model_kd2sd.py:31-34 stops at aux21)
            aux_layers.append(ConvLayer(
                name=f"aux{k}1", in_ch=enc_in[name], out_ch=t_enc_in[name],
                kernel=1, relu=False, tap=f"dec_aux{k}1",
            ))
    return StageSpec("decoder", family, stage, tuple(layers), tuple(aux_layers), has_conv0=False)
