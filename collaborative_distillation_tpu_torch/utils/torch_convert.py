"""Converters from the reference's legacy checkpoints to the weight store.

The reference ships weights in two legacy formats:

* torch ``.pth`` files, ``{"epoch": int, "model": state_dict}`` or a bare
  state dict (main.py:131-134, model_cd.py:71-77), written by torch 0.4.1
  in the legacy (non-zip) serialization;
* Torch7 Lua ``.t7`` files for the teacher VGG autoencoders, once read
  through the long-removed ``torch.utils.serialization.load_lua``
  (model_original.py:26, 452-486).

This module converts either into the store's flat ``{conv_name: {"w": HWIO
float32, "b": (out,) float32}}`` tree (``models/zoo.py:save_tree_npz``
writes it). A ``.pth`` is read with ``torch.load(weights_only=True)``: its
tensors, numbers, strings and containers, in the legacy format and the zip
one alike, and nothing that needs arbitrary unpickling; such a file is
refused (:class:`UnsafeCheckpoint`). The reference package loads with
``weights_only=False``. The work is file formats and numpy on the host: no
tensor goes to any device.
"""

from __future__ import annotations

import pickle
import re

import numpy as np
import torch

__all__ = ["UnsafeCheckpoint", "load_pth", "state_dict_to_tree", "convert_pth",
           "convert_t7_sequential", "T7_ENCODER_LAYER_INDEX", "T7_DECODER_LAYER_INDEX"]


class UnsafeCheckpoint(ValueError):
    """A ``.pth`` file holds objects that only arbitrary unpickling could
    rebuild (classes, functions), so it is not loaded."""


def load_pth(path: str):
    """``torch.load`` of ``path`` on the CPU with ``weights_only=True``:
    tensors, numbers, strings and dict/list/tuple containers, zip or legacy
    format. Raises :class:`UnsafeCheckpoint` for anything else."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        first = str(e).strip().splitlines()[-1] if str(e).strip() else type(e).__name__
        raise UnsafeCheckpoint(
            f"{path}: refused, it holds objects beyond tensors, numbers, strings and "
            f"containers, which only arbitrary unpickling would rebuild ({first}). Re-save "
            f"its state dict alone (torch.save(model.state_dict(), path)) where the "
            f"file is trusted.") from None


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    if w.ndim != 4:
        raise ValueError(f"expected 4-D conv weight, got shape {w.shape}")
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _array(val) -> np.ndarray:
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu().numpy()
    return np.asarray(val, dtype=np.float32)


def state_dict_to_tree(state_dict) -> dict[str, dict[str, np.ndarray]]:
    """torch state dict ``{name.weight/bias: tensor}`` -> ``{name: {"w": HWIO,
    "b"}}``, float32."""
    tree: dict[str, dict[str, np.ndarray]] = {}
    for key, val in state_dict.items():
        m = re.fullmatch(r"(.+)\.(weight|bias)", key)
        if not m:
            raise ValueError(f"unrecognized state-dict key {key!r}")
        name, kind = m.groups()
        arr = _array(val)
        tree.setdefault(name, {})["w" if kind == "weight" else "b"] = (
            _oihw_to_hwio(arr) if kind == "weight" else arr)
    for name, entry in tree.items():
        if "w" not in entry or "b" not in entry:
            raise ValueError(f"layer {name!r} missing weight or bias")
    return tree


def convert_pth(path: str) -> dict[str, dict[str, np.ndarray]]:
    """Load a ``.pth`` (a state dict, bare or wrapped as ``{"model": sd}``)
    and convert it: where no value of the top dict is a tensor, its first
    dict value is the state dict, as the reference's ``smart_load`` sniffs
    (utils.py:90-98)."""
    obj = load_pth(path)
    if isinstance(obj, dict) and not any(isinstance(v, torch.Tensor) for v in obj.values()):
        for v in obj.values():
            if isinstance(v, dict):
                obj = v
                break
    return state_dict_to_tree(obj)


# Torch7 nn.Sequential module index -> conv name, for the teacher models.
# Mirrors the explicit load_param tables in model_original.py (Encoder5 t7
# branch at 452-486 and Decoder5 at 561-575); index 0 is the conv0
# preprocessing layer present in all encoder t7 files.
T7_ENCODER_LAYER_INDEX: dict[int, dict[int, str]] = {
    1: {0: "conv0", 2: "conv11"},
    2: {0: "conv0", 2: "conv11", 5: "conv12", 9: "conv21"},
    3: {0: "conv0", 2: "conv11", 5: "conv12", 9: "conv21", 12: "conv22", 16: "conv31"},
    4: {0: "conv0", 2: "conv11", 5: "conv12", 9: "conv21", 12: "conv22", 16: "conv31",
        19: "conv32", 22: "conv33", 25: "conv34", 29: "conv41"},
    5: {0: "conv0", 2: "conv11", 5: "conv12", 9: "conv21", 12: "conv22", 16: "conv31",
        19: "conv32", 22: "conv33", 25: "conv34", 29: "conv41", 32: "conv42",
        35: "conv43", 38: "conv44", 42: "conv51"},
}
T7_DECODER_LAYER_INDEX: dict[int, dict[int, str]] = {
    1: {1: "conv11"},
    2: {1: "conv21", 5: "conv12", 8: "conv11"},
    3: {1: "conv31", 5: "conv22", 8: "conv21", 12: "conv12", 15: "conv11"},
    4: {1: "conv41", 5: "conv34", 8: "conv33", 11: "conv32", 14: "conv31",
        18: "conv22", 21: "conv21", 25: "conv12", 28: "conv11"},
    5: {1: "conv51", 5: "conv44", 8: "conv43", 11: "conv42", 14: "conv41",
        18: "conv34", 21: "conv33", 24: "conv32", 27: "conv31", 31: "conv22",
        34: "conv21", 38: "conv12", 41: "conv11"},
}


def convert_t7_sequential(path: str, index_map: dict[int, str]) -> dict[str, dict[str, np.ndarray]]:
    """Convert a Torch7 ``.t7`` nn.Sequential checkpoint through the port's
    own deserializer (:mod:`.t7reader`), picking the convs at the flat
    module indices of ``index_map``."""
    from .t7reader import read_t7_conv_layers

    layers = read_t7_conv_layers(path)
    tree: dict[str, dict[str, np.ndarray]] = {}
    for idx, name in index_map.items():
        if idx not in layers:
            raise KeyError(f"{path}: t7 module index {idx} not found (have {sorted(layers)})")
        w, b = layers[idx]
        tree[name] = {"w": _oihw_to_hwio(w.astype(np.float32)), "b": b.astype(np.float32)}
    return tree
