"""Spec-driven apply functions for the WCT VGG autoencoders.

One multi-tap ``apply_encoder`` covers the reference's ``forward``,
``forward_branch`` and ``forward_aux*`` families: it returns a dict of named
features and callers pick what they need.

Params are flat dicts ``{conv_name: {"w": HWIO, "b": (out,)}}`` keyed by the
reference state-dict names, from :mod:`.zoo`, :mod:`..utils.params` or
:func:`init_params`. :class:`Encoder` and :class:`Decoder` hold such a dict
as ``nn.Module`` parameters and call the same functions.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.conv import conv1x1, conv3x3, max_pool_2x2, upsample_nearest_2x
from .specs import StageSpec

__all__ = ["init_params", "apply_encoder", "apply_decoder", "Encoder", "Decoder"]

Params = dict[str, dict[str, torch.Tensor]]


def init_params(spec: StageSpec, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> Params:
    """Kaiming-uniform init matching torch Conv2d defaults, drawn from
    ``generator`` (on the CPU, then moved to ``device``)."""
    params: Params = {}
    for name, (wshape, bshape) in sorted(spec.param_shapes().items()):
        kh, kw, cin, _ = wshape
        fan_in = kh * kw * cin
        bound_w = math.sqrt(1.0 / fan_in) * math.sqrt(3.0)
        bound_b = 1.0 / math.sqrt(fan_in)
        w = (torch.rand(wshape, generator=generator, dtype=dtype) * 2 - 1) * bound_w
        b = (torch.rand(bshape, generator=generator, dtype=dtype) * 2 - 1) * bound_b
        params[name] = {"w": w.to(device), "b": b.to(device)}
    return params


def apply_encoder(params: Params, x: torch.Tensor, spec: StageSpec, *,
                  aux_relu: bool = False, aux: bool = True) -> dict[str, torch.Tensor]:
    """Run an encoder stage on an NHWC map; returns named features.

    Keys: ``out`` (final relu{k}_1), ``relu{j}1`` taps (j<=k, pre-pool) and
    ``aux{j}1`` adapter outputs when the spec has aux layers. ``aux_relu``
    mirrors the reference's ``updim_relu`` flag. ``aux=False`` skips the
    adapters: the reference's jit drops unused taps, eager PyTorch computes
    them, and at 2048^2 they map every tap up to teacher width (64..512
    channels) at full resolution for a stylization that never reads them.
    """
    if spec.kind != "encoder":
        raise ValueError(f"apply_encoder needs an encoder spec, got {spec.kind!r}")
    outs: dict[str, torch.Tensor] = {}
    if spec.has_conv0:
        p = params["conv0"]
        x = conv1x1(x, p["w"], p["b"], relu=False)
    for layer in spec.layers:
        p = params[layer.name]
        x = conv3x3(x, p["w"], p["b"], relu=layer.relu)
        if layer.tap:
            outs[layer.tap] = x
        if layer.pool_after:
            x = max_pool_2x2(x)
    outs["out"] = x
    for layer in spec.aux if aux else ():
        src = outs[f"relu{layer.name[4]}1"]
        p = params[layer.name]
        outs[layer.tap] = conv1x1(src, p["w"], p["b"], relu=aux_relu)
    return outs


def apply_decoder(params: Params, x: torch.Tensor, spec: StageSpec, *,
                  aux_relu: bool = False, final_relu: bool = True) -> dict[str, torch.Tensor]:
    """Run a decoder stage; returns named features.

    Keys: ``out`` (reconstructed image, ReLU'd like the reference), ``dec{j}1``
    taps (the upsampled conv{j}1 features) and kd2sd ``dec_aux{j}1`` adapter
    outputs when present. ``final_relu=False`` is the reference's
    ``Decoder4.forward_norule`` variant (no ReLU on the last conv).
    """
    if spec.kind != "decoder":
        raise ValueError(f"apply_decoder needs a decoder spec, got {spec.kind!r}")
    outs: dict[str, torch.Tensor] = {}
    last = spec.layers[-1]
    for layer in spec.layers:
        p = params[layer.name]
        relu = layer.relu and (final_relu or layer is not last)
        x = conv3x3(x, p["w"], p["b"], relu=relu)
        if layer.unpool_after:
            x = upsample_nearest_2x(x)
        if layer.tap:
            outs[layer.tap] = x
    outs["out"] = x
    for layer in spec.aux:
        src = outs[f"dec{layer.name[3]}1"]
        p = params[layer.name]
        outs[layer.tap] = conv1x1(src, p["w"], p["b"], relu=aux_relu)
    return outs


class _Stage(nn.Module):
    """HWIO parameters of one stage as frozen ``nn.Parameter``s (the port has
    no backward kernels yet, so the modules are for inference). Takes loaded
    ``params``, or draws them with :func:`init_params` from ``generator``."""

    def __init__(self, spec: StageSpec, params: Params | None = None, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if params is None:
            if generator is None:
                raise ValueError("pass params, or a torch.Generator to draw them")
            params = init_params(spec, generator)
        self.spec = spec
        self.convs = nn.ModuleDict()
        for name in spec.param_shapes():
            m = nn.Module()
            m.w = nn.Parameter(params[name]["w"], requires_grad=False)
            m.b = nn.Parameter(params[name]["b"], requires_grad=False)
            self.convs[name] = m

    def params(self) -> Params:
        return {name: {"w": m.w, "b": m.b} for name, m in self.convs.items()}


class Encoder(_Stage):
    def forward(self, x: torch.Tensor, *, aux_relu: bool = False,
                aux: bool = True) -> dict[str, torch.Tensor]:
        return apply_encoder(self.params(), x, self.spec, aux_relu=aux_relu, aux=aux)


class Decoder(_Stage):
    def forward(self, x: torch.Tensor, *, aux_relu: bool = False,
                final_relu: bool = True) -> dict[str, torch.Tensor]:
        return apply_decoder(self.params(), x, self.spec, aux_relu=aux_relu,
                             final_relu=final_relu)
