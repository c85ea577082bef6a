"""Model zoo: inference mode -> (spec, weights) over the ``.npz`` weight store.

The store is the one the reference package writes (``weights/<family>/
{e,d}{k}.npz``, HWIO weights keyed ``<layer>/w`` and ``<layer>/b``); this
module reads it into torch tensors on the requested device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .specs import StageSpec, decoder_spec, encoder_spec

__all__ = ["default_weights_root", "stage_specs", "load_stage_params",
           "load_pyramid", "load_tree_npz", "save_tree_npz", "PREPROC_CONV0"]

# The hardcoded preprocessing conv baked into Encoder5 (model_original.py:428-433):
# RGB->BGR, x255, subtract the Caffe VGG ImageNet mean. HWIO layout.
PREPROC_CONV0 = {
    "w": np.array([[[[0.0, 0.0, 255.0],
                     [0.0, 255.0, 0.0],
                     [255.0, 0.0, 0.0]]]], dtype=np.float32),  # (1,1,3,3) HWIO
    "b": np.array([-103.939, -116.779, -123.68], dtype=np.float32),
}


def default_weights_root() -> str:
    env = os.environ.get("CD_TPU_WEIGHTS")
    if env:
        return env
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "weights")


def load_tree_npz(path: str) -> dict[str, dict[str, np.ndarray]]:
    """``{"<layer>/<w|b>": array}`` npz -> ``{layer: {"w": .., "b": ..}}``."""
    with np.load(path) as data:
        tree: dict[str, dict[str, np.ndarray]] = {}
        for key in data.files:
            name, kind = key.rsplit("/", 1)
            tree.setdefault(name, {})[kind] = data[key]
    return tree


def save_tree_npz(tree, path: str) -> None:
    """``{layer: {"w": .., "b": ..}}`` (numpy arrays or tensors) -> a store
    entry at ``path`` that :func:`load_tree_npz` reads back, in the
    reference's layout (flat ``<layer>/<w|b>`` keys); makes the directory."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{f"{name}/{kind}": (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                                         else np.asarray(a))
                      for name, leaf in tree.items() for kind, a in leaf.items()})


def _family_and_dirs(mode: str) -> tuple[str, str, str]:
    """mode -> (family, encoder subdir, decoder subdir)."""
    if mode == "original":
        return "original", "original", "original"
    if mode == "16x":
        return "16x", "16x", "16x"
    if mode == "16x_kd2sd":
        return "16x", "16x", "16x_kd2sd"
    if mode == "16x_base":
        return "16x", "16x_base", "16x_base"
    raise ValueError(f"unknown mode {mode!r} (original | 16x | 16x_kd2sd | 16x_base)")


def stage_specs(mode: str, stage: int) -> tuple[StageSpec, StageSpec]:
    """(encoder_spec, decoder_spec) for an inference mode."""
    family, _, _ = _family_and_dirs(mode)
    enc = encoder_spec(family, stage, aux=(family == "16x"))
    dec = decoder_spec(family, stage, aux=(mode == "16x_kd2sd"))
    return enc, dec


def load_stage_params(path: str, spec: StageSpec, device="cpu"):
    """Load one stage's params as float32 tensors on ``device``; validates
    shapes against the spec.

    Missing aux layers (the pruned-init base checkpoints carry no decoder aux)
    are zero-initialized. A missing conv0 falls back to the hardcoded
    preprocessing conv (the t7 teachers before normalization lacked it).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"weight store entry not found: {path} (the store is written by "
            f"the reference package's converters, cli/convert.py)")
    tree = load_tree_npz(path)
    expected = spec.param_shapes()
    params = {}
    for name, (wshape, bshape) in expected.items():
        if name in tree:
            w = np.asarray(tree[name]["w"], np.float32)
            b = np.asarray(tree[name]["b"], np.float32)
        elif name == "conv0":
            w, b = PREPROC_CONV0["w"], PREPROC_CONV0["b"]
        elif name.endswith("_aux") or name.startswith("aux"):
            w = np.zeros(wshape, np.float32)
            b = np.zeros(bshape, np.float32)
        else:
            raise KeyError(f"{path}: missing layer {name!r}")
        if w.shape != wshape or b.shape != bshape:
            raise ValueError(
                f"{path}: layer {name!r} shape {w.shape}/{b.shape} != spec {wshape}/{bshape}")
        params[name] = {"w": torch.from_numpy(np.ascontiguousarray(w)).to(device),
                        "b": torch.from_numpy(np.ascontiguousarray(b)).to(device)}
    extra = set(tree) - set(expected)
    if extra:
        raise ValueError(f"{path}: unexpected layers {sorted(extra)}")
    return params


def load_pyramid(mode: str, weights_root: str | None = None, *,
                 stages=(5, 4, 3, 2, 1), device="cpu"):
    """Load the 5-level encoder/decoder pyramid for a mode.

    Returns ``{stage: {"enc_spec", "dec_spec", "enc", "dec"}}``.
    """
    root = weights_root or default_weights_root()
    _, enc_dir, dec_dir = _family_and_dirs(mode)
    pyramid = {}
    for k in stages:
        enc_spec, dec_spec_ = stage_specs(mode, k)
        pyramid[k] = {
            "enc_spec": enc_spec,
            "dec_spec": dec_spec_,
            "enc": load_stage_params(os.path.join(root, enc_dir, f"e{k}.npz"), enc_spec, device),
            "dec": load_stage_params(os.path.join(root, dec_dir, f"d{k}.npz"), dec_spec_, device),
        }
    return pyramid
