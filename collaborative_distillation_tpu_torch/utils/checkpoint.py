"""Checkpoint save and restore in the reference package's format.

A checkpoint is a tree of dicts, lists and tuples whose leaves are arrays
(or Python scalars and strings, stored as 0-d arrays), written as one flat
``.npz``: the key of a leaf is its path, ``params/conv11/w``, and an empty
tuple leaves no key. A ``None`` leaf is a ``<path>/__none__`` marker and a
value that is no array a ``<path>/__json__`` string. The file is written
beside its target and moved over it with ``os.replace``, so a crash mid-save
leaves the previous checkpoint whole. The reference writes and reads the
same keys, so a checkpoint crosses between the two packages both ways. (Its
orbax backend is a JAX library and is not ported.)
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def _leaf(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[f"{prefix}__none__"] = np.zeros(0)
    else:
        arr = _leaf(tree)
        if arr.dtype == object:
            out[f"{prefix}__json__"] = np.asarray([json.dumps(tree)])
        else:
            out[prefix[:-1]] = arr
    return out


def save_checkpoint(path: str, tree) -> None:
    """Save a tree (dicts, lists, tuples; tensor, array or scalar leaves) to
    ``<path>.npz``."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(tree)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str, like):
    """Restore a tree with the structure (and leaf shapes) of ``like``, as
    numpy arrays. Lists and tuples take their structure from the template,
    so the file stays a flat name -> array map."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}

    def build(prefix, template):
        if isinstance(template, dict):
            return {k: build(f"{prefix}{k}/", v) for k, v in template.items()}
        if isinstance(template, (list, tuple)):
            return type(template)(build(f"{prefix}{i}/", v) for i, v in enumerate(template))
        if template is None:
            if f"{prefix}__none__" not in flat:
                raise KeyError(f"checkpoint missing None marker at {prefix!r}")
            return None
        if f"{prefix}__json__" in flat:
            return json.loads(str(flat[f"{prefix}__json__"][0]))
        key = prefix[:-1]
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        shape = tuple(template.shape) if hasattr(template, "shape") else None
        if shape is not None and tuple(arr.shape) != shape:
            raise ValueError(f"checkpoint leaf {key!r} shape {arr.shape} != expected {shape}")
        return arr

    return build("", like)
