"""A configuration's weights: read from its files, or drawn on the card from
the seed in one call. Both give ``{stage: {"enc": params, "dec": params}}``
with ``params = {layer: {"w": HWIO, "b": (cout,)}}``: the same tensors go to
the program and to the reference."""

from __future__ import annotations

import hashlib
import math
import os

import numpy as np

from . import arch


def sub_seed(seed: int, tag: str) -> int:
    """An independent 63-bit stream of ``seed`` for ``tag``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(torch, seed: int, tag: str, device):
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def pyramid_groups(cfg: dict, stages=(1, 2, 3, 4, 5)) -> list:
    """(stage, "enc" | "dec", shapes) in a fixed order."""
    out = []
    for k in stages:
        out.append((k, "enc", arch.param_shapes(arch.encoder(cfg, k), conv0=True)))
        out.append((k, "dec", arch.param_shapes(arch.decoder(cfg, k), conv0=False)))
    return out


def draw(torch, groups: list, seed: int, tag: str, device, *, out_scale: float = 1.0,
         out_bias: float | None = None) -> list:
    """Every group's params from one ``torch.rand`` on ``device``: weights
    He-uniform (bound sqrt(6 / fan_in)), biases uniform within 1/sqrt(fan_in),
    conv0 the fixed preprocessing conv. A decoder's last conv (``conv11`` of
    a "dec" group) is scaled by ``out_scale``, its bias set to ``out_bias``."""
    sizes = [math.prod(ws) + math.prod(bs) for _, _, shapes in groups
             for name, (ws, bs) in shapes.items() if name != "conv0"]
    u = torch.rand(sum(sizes), generator=generator(torch, seed, tag, device), device=device)
    u = u.mul_(2).sub_(1)
    out, at = [], 0
    for _, kind, shapes in groups:
        params = {}
        for name, (ws, bs) in shapes.items():
            if name == "conv0":
                params[name] = {"w": torch.tensor(arch.CONV0_W, device=device),
                                "b": torch.tensor(arch.CONV0_B, device=device)}
                continue
            fan_in = ws[0] * ws[1] * ws[2]
            nw, nb = math.prod(ws), math.prod(bs)
            w = u[at:at + nw].view(ws) * math.sqrt(6.0 / fan_in)
            b = u[at + nw:at + nw + nb].view(bs) / math.sqrt(fan_in)
            at += nw + nb
            if kind == "dec" and name == "conv11":
                w = w * out_scale
                if out_bias is not None:
                    b = torch.full_like(b, out_bias)
            params[name] = {"w": w.contiguous(), "b": b.contiguous()}
        out.append(params)
    return out


def seeded_pyramid(torch, cfg: dict, seed: int, device, stages=(1, 2, 3, 4, 5)) -> dict:
    spec = cfg["weights"]
    groups = pyramid_groups(cfg, stages)
    params = draw(torch, groups, seed, "pyramid:" + cfg["name"], device,
                  out_scale=spec.get("decoder_out_scale", 1.0),
                  out_bias=spec.get("decoder_out_bias"))
    out: dict = {}
    for (k, kind, _), p in zip(groups, params):
        out.setdefault(k, {})[kind] = p
    return out


def file_pyramid(torch, cfg: dict, root: str, device, stages=(1, 2, 3, 4, 5)) -> dict:
    """The weight files ``<root>/<dir>/{e,d}<k>.npz`` (flat ``<layer>/<w|b>``
    keys), read with numpy; a missing conv0 is the fixed one."""
    spec = cfg["weights"]
    base = os.path.join(root, spec["root"], spec["dir"])
    out: dict = {}
    for k, kind, shapes in pyramid_groups(cfg, stages):
        with np.load(os.path.join(base, f"{kind[0]}{k}.npz")) as data:
            files = {key: data[key] for key in data.files}
        params = {}
        for name, (ws, bs) in shapes.items():
            if f"{name}/w" in files:
                w, b = files[f"{name}/w"], files[f"{name}/b"]
            elif name == "conv0":
                w, b = np.asarray(arch.CONV0_W), np.asarray(arch.CONV0_B)
            else:
                raise KeyError(f"{base}: no layer {name!r} in {kind[0]}{k}.npz")
            if tuple(w.shape) != ws or tuple(b.shape) != bs:
                raise ValueError(f"{base}/{kind[0]}{k}.npz: {name} is {w.shape}, not {ws}")
            params[name] = {"w": torch.tensor(np.asarray(w, np.float32), device=device),
                            "b": torch.tensor(np.asarray(b, np.float32), device=device)}
        out.setdefault(k, {})[kind] = params
    return out


def pyramid(torch, cfg: dict, seed: int, root: str, device, stages=(1, 2, 3, 4, 5)) -> dict:
    if cfg["weights"]["kind"] == "files":
        return file_pyramid(torch, cfg, root, device, stages)
    return seeded_pyramid(torch, cfg, seed, device, stages)


def seeded_student(torch, cfg: dict, stage: int, seed: int, device) -> dict:
    """The student encoder of ``stage`` with its aux adapters, drawn from the seed."""
    layers = arch.encoder(cfg, stage) + arch.aux(cfg, stage)
    groups = [(stage, "enc", arch.param_shapes(layers, conv0=True))]
    return draw(torch, groups, seed, "student:" + cfg["name"], device)[0]


def clone(tree: dict) -> dict:
    return {name: {kind: t.detach().clone() for kind, t in leaf.items()}
            for name, leaf in tree.items()}
