"""Checkpoint save and restore in the reference package's format.

A checkpoint is a tree of dicts, lists and tuples whose leaves are arrays
(or Python scalars and strings, stored as 0-d arrays), written as one flat
``.npz``: the key of a leaf is its path, ``params/conv11/w``, and an empty
tuple leaves no key. A ``None`` leaf is a ``<path>/__none__`` marker and a
value that is no array a ``<path>/__json__`` string. The file is written
beside its target and moved over it with ``os.replace``, so a crash mid-save
leaves the previous checkpoint whole. The reference writes and reads the
same keys, so a checkpoint crosses between the two packages both ways.

:func:`save_checkpoint_dcp` and :func:`load_checkpoint_dcp` are the port's
counterpart of the reference's orbax backend (``save_checkpoint_orbax``):
the same trees through ``torch.distributed.checkpoint`` into a directory,
in one process without a process group or collectively in a
``torch.distributed`` group (one process a card, the replicas identical:
each tensor is written once). The keys are the ``.npz`` ones; a text leaf
(a string, or a ``__json__`` value) is stored as its UTF-8 JSON bytes under
``<key>#text``, since a tensor holds no text.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import warnings

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "save_checkpoint_dcp", "load_checkpoint_dcp"]

_TEXT = "#text"


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


def _build(flat: dict, like):
    """The tree of ``like``'s structure from the flat ``{key: array}`` map."""

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


def load_checkpoint(path: str, like):
    """Restore a tree with the structure (and leaf shapes) of ``like``, as
    numpy arrays. Lists and tuples take their structure from the template,
    so the file stays a flat name -> array map."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    return _build(flat, like)


def _group() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


@contextlib.contextmanager
def _single_process_quiet():
    """Silence DCP's warning that it runs in a single process: without a
    group that is what these functions ask for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def save_checkpoint_dcp(path: str, tree) -> None:
    """Save a tree (as :func:`save_checkpoint` takes it) into the directory
    ``path`` through ``torch.distributed.checkpoint``, replacing what is
    there. In a ``torch.distributed`` group every process calls it with the
    same tree; each tensor is written once."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    flat = {}
    for key, arr in _flatten(tree).items():
        if arr.dtype.kind in "US":
            flat[key + _TEXT] = torch.frombuffer(
                bytearray(json.dumps(arr.tolist()).encode()), dtype=torch.uint8)
        else:
            flat[key] = torch.from_numpy(np.require(arr, requirements="C"))
    group = _group()
    if not group or torch.distributed.get_rank() == 0:
        shutil.rmtree(path, ignore_errors=True)
    if group:
        torch.distributed.barrier()
    with _single_process_quiet():
        dcp.save(flat, checkpoint_id=path, no_dist=not group)


def load_checkpoint_dcp(path: str, like):
    """Restore a tree saved by :func:`save_checkpoint_dcp` with the structure
    (and leaf shapes) of ``like``, as numpy arrays: what
    :func:`load_checkpoint` returns for the same tree. Each process of a
    group reads the whole tree."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    flat = {key: torch.empty(tuple(m.size), dtype=m.properties.dtype)
            for key, m in meta.items()}
    with _single_process_quiet():
        dcp.load(flat, checkpoint_id=path, no_dist=not _group())
    out = {}
    for key, t in flat.items():
        if key.endswith(_TEXT):
            out[key[:-len(_TEXT)]] = np.asarray(json.loads(bytes(t.numpy()).decode()))
        else:
            out[key] = t.numpy()
    return _build(out, like)
