"""Inference inputs: image folders decoded into numpy arrays.

The port's copy of the inference part of the reference package's pipeline,
with the same names and semantics, reading files through
:mod:`..utils.image` instead of PIL:

* :class:`CenterCropDataset` — shorter-side resize, deterministic centre
  crop (the evaluation images);
* :class:`PairGridDataset` — the content x style cross product with
  picked-mark filtering, optional shorter-side resizes, output names
  ``content+style.jpg`` and the texture-synthesis branch (uniform noise
  content of the texture's size).

Arrays are (H, W, 3) float32 in [0, 1] unless said otherwise. The training
datasets and the loader belong to the training slice.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.image import read_image, resize

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg")

__all__ = ["is_img", "load_image", "resize_shorter_side", "CenterCropDataset",
           "PairGridDataset"]


def is_img(name: str) -> bool:
    return name.lower().endswith(IMG_EXTENSIONS)


def load_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB."""
    return read_image(path)


def resize_shorter_side(img: np.ndarray, size: int) -> np.ndarray:
    """Resize a uint8 image so that its shorter side is ``size`` (the longer
    one truncated, at least 1), with PIL's default filter."""
    h, w = img.shape[:2]
    if w < h:
        return resize(img, size, max(1, int(h * size / w)))
    return resize(img, max(1, int(w * size / h)), size)


def _to_float(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, np.float32) / 255.0


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    i, j = max(0, (h - size) // 2), max(0, (w - size) // 2)
    return arr[i: i + size, j: j + size]


class CenterCropDataset:
    """Eval images: resize shorter side + deterministic center crop."""

    def __init__(self, img_dir: str, shorter_side: int = 300, crop: int = 256):
        self.paths = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir) if is_img(f))
        self.shorter_side = shorter_side
        self.crop = crop

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, str]:
        img = load_image(self.paths[idx])
        if self.shorter_side:
            img = resize_shorter_side(img, self.shorter_side)
        return _center_crop(_to_float(img), self.crop), self.paths[idx]


class PairGridDataset:
    """Inference pairs: content x style cross product, or texture synthesis.

    Picked-mark substring filters, optional shorter-side resizes, output name
    ``content+style.jpg``, and the synthesis branch pairing each texture with
    uniform noise of the same size, as the reference's inference data loader
    intends.
    """

    def __init__(self, content_dir: str, style_dir: str, *, texture_dir: str | None = None,
                 content_size: int = 0, style_size: int = 0,
                 picked_content_mark: str = "", picked_style_mark: str = "",
                 synthesis: bool = False, seed: int = 0):
        self.synthesis = synthesis
        self.content_size = content_size
        self.style_size = style_size
        self.rng = np.random.default_rng(seed)
        if synthesis:
            self.textures = sorted(
                os.path.join(texture_dir, f) for f in os.listdir(texture_dir) if is_img(f))
            self.pairs = [(t, t) for t in self.textures]
        else:
            contents = sorted(f for f in os.listdir(content_dir)
                              if is_img(f) and picked_content_mark in f)
            styles = sorted(f for f in os.listdir(style_dir)
                            if is_img(f) and picked_style_mark in f)
            self.pairs = [(os.path.join(content_dir, c), os.path.join(style_dir, s))
                          for c in contents for s in styles]

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray, str]:
        cpath, spath = self.pairs[idx]
        style = load_image(spath)
        if self.style_size:
            style = resize_shorter_side(style, self.style_size)
        style = _to_float(style)
        if self.synthesis:
            content = self.rng.random(style.shape, dtype=np.float32)
            name = os.path.basename(cpath).rsplit(".", 1)[0] + ".jpg"
        else:
            content = load_image(cpath)
            if self.content_size:
                content = resize_shorter_side(content, self.content_size)
            content = _to_float(content)
            name = (os.path.basename(cpath).rsplit(".", 1)[0] + "+" +
                    os.path.basename(spath).rsplit(".", 1)[0] + ".jpg")
        return content, style, name
