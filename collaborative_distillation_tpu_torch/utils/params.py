"""Carry parameters from the reference package into the port.

The reference keeps a stage's parameters as ``{layer: {"w": HWIO, "b": (out,)}}``
and a pyramid as ``{stage: {"enc_spec", "dec_spec", "enc", "dec"}}``. These
functions take such trees with numpy leaves (any array that ``np.asarray``
reads, so the caller converts) and return the port's: float32 torch tensors
on one device, with the specs rebuilt as the port's own dataclasses.

:func:`adam_state_to_jax` and :func:`adam_state_from_jax` carry an Adam
state between ``torch.optim.Adam.state_dict()`` (``step``, ``exp_avg``,
``exp_avg_sq`` by parameter index) and optax's ``ScaleByAdamState``
(``count``, ``mu``, ``nu`` as trees shaped like the parameters), the fields
the reference's checkpoints store.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.specs import ConvLayer, StageSpec

__all__ = ["params_from_jax", "pyramid_from_jax", "spec_from_jax", "adam_state_to_jax",
           "adam_state_from_jax"]


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


def _order(params) -> list[tuple[str, str]]:
    """(layer, kind) of each parameter in the order an optimizer built from
    ``[t for leaf in params.values() for t in leaf.values()]`` indexes them."""
    return [(layer, kind) for layer, leaf in params.items() for kind in leaf]


def adam_state_to_jax(state_dict, params):
    """``torch.optim.Adam.state_dict()`` of an optimizer over ``params`` (in
    their dict order) -> ``(count, mu, nu)``: int32 step count and numpy
    trees shaped like ``params`` (zeros before the first step)."""
    state = state_dict["state"]
    count = int(state[0]["step"]) if state else 0
    mu = {layer: {} for layer in params}
    nu = {layer: {} for layer in params}
    for i, (layer, kind) in enumerate(_order(params)):
        s = state.get(i)
        for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            tree[layer][kind] = (s[key].detach().cpu().numpy() if s is not None
                                 else np.zeros(tuple(params[layer][kind].shape), np.float32))
    return np.int32(count), mu, nu


def adam_state_from_jax(count, mu, nu, params, param_groups):
    """optax's ``(count, mu, nu)`` -> an Adam ``state_dict`` for an optimizer
    over ``params`` (in their dict order) with ``param_groups``, its tensors
    on the parameters' device."""
    state = {}
    for i, (layer, kind) in enumerate(_order(params)):
        dev = params[layer][kind].device
        state[i] = {"step": torch.tensor(float(np.asarray(count))),
                    "exp_avg": torch.tensor(np.asarray(mu[layer][kind], np.float32), device=dev),
                    "exp_avg_sq": torch.tensor(np.asarray(nu[layer][kind], np.float32),
                                               device=dev)}
    return {"state": state, "param_groups": param_groups}
