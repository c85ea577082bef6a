"""L1-norm filter pruning: teacher weights -> student initialization.

The port's numpy copy of the reference package's ``train/prune.py``, itself a
reimplementation of the original tools/prune.py: keep the filters with the
largest L1 norms, chaining each layer's kept-filter indices into the next
layer's kept-column indices (prune.py:29-37, 100-124). Operates on our HWIO
param trees and declarative specs instead of torch state dicts, and handles
encoders and decoders uniformly (the reference special-cases the decoder's
first layer by pruning input channels by channel-L1, prune.py:117-121).

Aux adapters have no teacher counterpart and are left at their provided
initialization (same as the reference, whose state-dict walk never visits
them).
"""

from __future__ import annotations

import numpy as np

from ..models.specs import StageSpec

__all__ = ["l1_keep_indices", "prune_to_student"]


def l1_keep_indices(w_hwio: np.ndarray, n_keep: int, *, axis: str = "out") -> np.ndarray:
    """Indices of the ``n_keep`` filters (axis='out') or input channels
    (axis='in') with the largest L1 norm. Sorted ascending to keep the
    original channel order stable (argsort tail, like prune.py:32-33)."""
    if axis == "out":
        norms = np.abs(w_hwio).sum(axis=(0, 1, 2))
    elif axis == "in":
        norms = np.abs(w_hwio).sum(axis=(0, 1, 3))
    else:
        raise ValueError(axis)
    return np.sort(np.argsort(norms)[-n_keep:])


def prune_to_student(teacher_params, student_spec: StageSpec, *, init_aux=None):
    """Build a student init by L1-pruning the teacher's conv stack.

    ``teacher_params``: param tree of the same-kind teacher stage (layer names
    align 1:1 by construction). Returns a full student param tree; aux layers
    come from ``init_aux`` (a params tree, e.g. from ``init_params``) or zeros.
    """
    out: dict = {}
    prev_keep: np.ndarray | None = None
    main_layers = [l for l in student_spec.layers]

    if student_spec.has_conv0:
        w = np.asarray(teacher_params["conv0"]["w"])
        b = np.asarray(teacher_params["conv0"]["b"])
        out["conv0"] = {"w": w, "b": b}  # 3->3 preprocessing conv, never pruned

    for i, layer in enumerate(main_layers):
        w = np.asarray(teacher_params[layer.name]["w"])  # (kh, kw, in, out)
        b = np.asarray(teacher_params[layer.name]["b"])
        # columns (input channels)
        if prev_keep is not None:
            w = w[:, :, prev_keep, :]
        elif w.shape[2] != layer.in_ch:
            # decoder first layer: teacher input width > student input width;
            # prune input channels by their own L1 norm (prune.py:117-121)
            cols = l1_keep_indices(w, layer.in_ch, axis="in")
            w = w[:, :, cols, :]
        # rows (filters)
        if w.shape[3] != layer.out_ch:
            keep = l1_keep_indices(w, layer.out_ch, axis="out")
        else:
            keep = np.arange(w.shape[3])
        out[layer.name] = {"w": w[:, :, :, keep], "b": b[keep]}
        prev_keep = keep

    for layer in student_spec.aux:
        if init_aux is not None and layer.name in init_aux:
            out[layer.name] = {
                "w": np.asarray(init_aux[layer.name]["w"]),
                "b": np.asarray(init_aux[layer.name]["b"]),
            }
        else:
            k = layer.kernel
            out[layer.name] = {
                "w": np.zeros((k, k, layer.in_ch, layer.out_ch), np.float32),
                "b": np.zeros((layer.out_ch,), np.float32),
            }
    return out
