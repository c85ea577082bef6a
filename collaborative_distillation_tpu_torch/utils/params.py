"""Carry parameters from the reference package into the port.

The reference keeps a stage's parameters as ``{layer: {"w": HWIO, "b": (out,)}}``
and a pyramid as ``{stage: {"enc_spec", "dec_spec", "enc", "dec"}}``. These
functions take such trees with numpy leaves (any array that ``np.asarray``
reads, so the caller converts) and return the port's: float32 torch tensors
on one device, with the specs rebuilt as the port's own dataclasses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.specs import ConvLayer, StageSpec

__all__ = ["params_from_jax", "pyramid_from_jax", "spec_from_jax"]


def params_from_jax(tree, device="cpu") -> dict[str, dict[str, torch.Tensor]]:
    """``{name: {"w": HWIO, "b": (out,)}}`` arrays -> float32 tensors on ``device``."""
    return {name: {kind: torch.tensor(np.asarray(a, np.float32), device=device)
                   for kind, a in leaf.items()}
            for name, leaf in tree.items()}


def spec_from_jax(spec) -> StageSpec:
    """Rebuild a reference ``StageSpec`` (same fields) as the port's."""
    if isinstance(spec, StageSpec):
        return spec
    d = dataclasses.asdict(spec)
    return StageSpec(kind=d["kind"], family=d["family"], stage=d["stage"],
                     layers=tuple(ConvLayer(**l) for l in d["layers"]),
                     aux=tuple(ConvLayer(**l) for l in d["aux"]),
                     has_conv0=d["has_conv0"])


def pyramid_from_jax(pyramid_np, device="cpu"):
    """A whole reference pyramid -> the port's, on ``device``."""
    return {k: {"enc_spec": spec_from_jax(v["enc_spec"]),
                "dec_spec": spec_from_jax(v["dec_spec"]),
                "enc": params_from_jax(v["enc"], device),
                "dec": params_from_jax(v["dec"], device)}
            for k, v in pyramid_np.items()}
