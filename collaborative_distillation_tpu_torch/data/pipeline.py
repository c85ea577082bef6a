"""Input pipelines: image folders decoded into numpy arrays.

The port's copy of the reference package's pipeline, with the same names,
semantics and random streams, reading files through :mod:`..utils.image`
instead of PIL. Every dataset of image files takes a ``device`` whose
codec reads its JPEGs (``"cpu"``: libjpeg on the host, which raises
``CodecUnavailable`` where it does not build; a CUDA device: nvJPEG). The
training datasets on a card decode and resize each JPEG there
(``jpeg.decode_jpeg_shorter_side``) and fetch the resized image; all after
the decode is host numpy, as on the CPU:

* :class:`ImageFolderDataset` — training content: shorter-side resize,
  random crop, random hflip (or ``aug="strong"``);
* :class:`NpyFolderDataset` — pre-decoded ``.npy`` folders;
* :class:`ContentStylePairDataset` — a content and a style folder zipped,
  each with the training recipe;
* :class:`CenterCropDataset` — shorter-side resize, deterministic centre
  crop (the evaluation images);
* :class:`PairGridDataset` — the content x style cross product with
  picked-mark filtering, optional shorter-side resizes, output names
  ``content+style.jpg`` and the texture-synthesis branch (uniform noise
  content of the texture's size);
* :class:`Loader` — shuffling, batching, and decode/augment in a thread
  pool with prefetched batches.

Arrays are (H, W, 3) float32 in [0, 1] unless said otherwise.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils.image import read_image, resize
from ..utils.transfer import fetch
from . import jpeg, native_codec

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg")

__all__ = ["is_img", "load_image", "resize_shorter_side", "ImageFolderDataset",
           "NpyFolderDataset", "ContentStylePairDataset", "CenterCropDataset",
           "PairGridDataset", "Loader"]


def is_img(name: str) -> bool:
    return name.lower().endswith(IMG_EXTENSIONS)


def load_image(path: str, device="cpu") -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB on the host; a JPEG decoded by
    ``device``'s codec (the datasets decode on the host unless a CLI that
    runs on the card passes its device)."""
    return read_image(path, device=device)


def resize_shorter_side(img: np.ndarray, size: int) -> np.ndarray:
    """Resize a uint8 image so that its shorter side is ``size`` (the longer
    one truncated, at least 1), with PIL's default filter."""
    h, w = img.shape[:2]
    if w < h:
        return resize(img, size, max(1, int(h * size / w)))
    return resize(img, max(1, int(w * size / h)), size)


def _to_float(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, np.float32) / 255.0


def _random_crop(arr: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    h, w = arr.shape[:2]
    if h < size or w < size:  # an image under the crop is reflect-padded up to it
        ph, pw = max(0, size - h), max(0, size - w)
        arr = np.pad(arr, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        h, w = arr.shape[:2]
    i = int(rng.integers(0, h - size + 1))
    j = int(rng.integers(0, w - size + 1))
    return arr[i: i + size, j: j + size]


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    i, j = max(0, (h - size) // 2), max(0, (w - size) // 2)
    return arr[i: i + size, j: j + size]


class _SafeRng:
    """Thread-safe random stream: an independent child generator per draw
    (numpy Generators are not thread-safe, and the Loader calls datasets
    from a thread pool). Deterministic given the seed and the draw order."""

    def __init__(self, seed: int):
        self._seq = np.random.SeedSequence(seed)
        self._lock = threading.Lock()

    def child(self) -> np.random.Generator:
        with self._lock:
            (child,) = self._seq.spawn(1)
        return np.random.default_rng(child)


class ImageFolderDataset:
    """Training content images: resize the shorter side, random ``crop``,
    random hflip (the reference's recipe).

    ``aug="strong"`` adds a log-uniform scale jitter (a bilinear re-resize
    of the decoded array down toward the crop size), the dihedral group,
    a random channel permutation, a mild intensity affine and, one time in
    four, a rectangle pasted from a second augmented crop: label-free
    transforms for small corpora, where the target is the input itself.
    ``cache=True`` keeps the decoded, resized arrays in memory (small
    folders only); ``uint8=True`` yields uint8 arrays for the trainer to
    normalize on the device.

    ``device``: the codec that reads the JPEGs. On a CUDA device each JPEG
    is decoded by nvJPEG and brought to the shorter side by the card's
    kernels (``shorter_side=0``: decoded whole), on a side stream of the
    calling thread's own under that device, then fetched; PNGs stay on the
    host. Where nvJPEG cannot load, a JPEG raises ``CodecUnavailable``
    (libjpeg is never used)."""

    def __init__(self, img_dir: str, shorter_side: int = 300, crop: int = 256, seed: int = 0,
                 cache: bool = False, uint8: bool = False, aug: str = "flip", device="cpu"):
        self.paths = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir) if is_img(f))
        if not self.paths:
            raise FileNotFoundError(f"no images in {img_dir}")
        self.shorter_side = shorter_side
        self.crop = crop
        self._rng = _SafeRng(seed)
        self._cache: dict[str, np.ndarray] | None = {} if cache else None
        self.uint8 = uint8
        if aug not in ("flip", "strong"):
            raise ValueError(f"unknown aug mode {aug!r}")
        self.aug = aug
        self.device = torch.device(device)
        if (self.device.type == "cuda" and self.device.index is None
                and torch.cuda.is_available()):
            # the Loader's threads start on card 0: name this one
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._streams = threading.local()

    def __len__(self) -> int:
        return len(self.paths)

    def _decode_on_card(self, path: str) -> np.ndarray:
        """A JPEG decoded and resized on ``self.device``, fetched as uint8.
        The work goes on this thread's own side stream: the thread's current
        stream is the card's default one, which the training step fills."""
        with open(path, "rb") as fh:
            data = fh.read()
        jpeg.require(self.device, f"read JPEG {path}")
        with torch.cuda.device(self.device):
            stream = getattr(self._streams, "stream", None)
            if stream is None:
                stream = self._streams.stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(stream):
                img = (jpeg.decode_jpeg_shorter_side(data, self.shorter_side, self.device)
                       if self.shorter_side else jpeg.decode_jpeg(data, self.device))
                if img is None:
                    raise ValueError(f"cannot decode JPEG {path}")
                return fetch(img)

    def _decode(self, path: str) -> np.ndarray:
        img = None
        is_jpeg = path.lower().endswith((".jpg", ".jpeg"))
        if is_jpeg and self.device.type == "cuda":
            img = self._decode_on_card(path)
            return img if self.uint8 else _to_float(img)
        if self.shorter_side and is_jpeg and native_codec.available():
            # decode with the DCT-domain downscale, the GIL released
            with open(path, "rb") as fh:
                img = native_codec.decode_jpeg_shorter_side(fh.read(), self.shorter_side)
        if img is None:
            img = load_image(path)
            if self.shorter_side:
                img = resize_shorter_side(img, self.shorter_side)
        return img if self.uint8 else _to_float(img)

    def _cached(self, path: str) -> np.ndarray:
        if self._cache is not None:
            arr = self._cache.get(path)
            if arr is None:
                # a benign race under the Loader's threads: both decode once
                arr = self._cache[path] = self._decode(path)
            return arr
        return self._decode(path)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, str]:
        path = self.paths[idx]
        arr = self._cached(path)
        rng = self._rng.child()
        if self.aug == "strong":
            out = self._strong_aug(arr, rng)
            if rng.random() < 0.25:   # paste a rectangle of a second crop
                j = int(rng.integers(0, len(self.paths)))
                other = self._strong_aug(self._cached(self.paths[j]), rng)
                ch = int(rng.integers(self.crop // 4, 3 * self.crop // 4))
                cw = int(rng.integers(self.crop // 4, 3 * self.crop // 4))
                i0 = int(rng.integers(0, self.crop - ch + 1))
                j0 = int(rng.integers(0, self.crop - cw + 1))
                out = out.copy()
                out[i0:i0 + ch, j0:j0 + cw] = other[i0:i0 + ch, j0:j0 + cw]
            return out, path
        arr = _random_crop(arr, self.crop, rng)
        if rng.random() < 0.5:
            arr = arr[:, ::-1].copy()
        return arr, path

    def _strong_aug(self, arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        h, w = arr.shape[:2]
        short = min(h, w)
        # log-uniform target shorter side in [crop, the decoded shorter side]
        if short > self.crop:
            t = int(round(float(np.exp(rng.uniform(np.log(self.crop), np.log(short))))))
            if t < short:
                nh = max(self.crop, int(round(h * t / short)))
                nw = max(self.crop, int(round(w * t / short)))
                a8 = arr if arr.dtype == np.uint8 else (arr * 255).astype(np.uint8)
                a8 = resize(a8, nw, nh, "bilinear")
                arr = a8 if self.uint8 else a8.astype(np.float32) / 255.0
        arr = _random_crop(arr, self.crop, rng)
        k = int(rng.integers(0, 8))  # dihedral group (square crop)
        if k & 1:
            arr = arr[:, ::-1]
        if k & 2:
            arr = arr[::-1]
        if k & 4:
            arr = np.transpose(arr, (1, 0, 2))
        if rng.random() < 0.5:
            arr = arr[..., rng.permutation(3)]
        if rng.random() < 0.5:  # mild intensity affine
            a = float(rng.uniform(0.85, 1.15))
            b = float(rng.uniform(-0.08, 0.08))
            if arr.dtype == np.uint8:
                arr = np.clip(arr.astype(np.float32) * a + b * 255.0,
                              0.0, 255.0).astype(np.uint8)
            else:
                arr = np.clip(arr * a + b, 0.0, 1.0)
        return np.ascontiguousarray(arr)


class NpyFolderDataset:
    """Pre-decoded ``.npy`` image folders: random crop and hflip."""

    def __init__(self, img_dir: str, crop: int = 256, seed: int = 0):
        self.paths = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir) if f.endswith(".npy"))
        if not self.paths:
            raise FileNotFoundError(f"no .npy files in {img_dir}")
        self.crop = crop
        self._rng = _SafeRng(seed)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, str]:
        arr = np.load(self.paths[idx])
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        rng = self._rng.child()
        arr = _random_crop(arr.astype(np.float32), self.crop, rng)
        if rng.random() < 0.5:
            arr = arr[:, ::-1].copy()
        return arr, self.paths[idx]


class ContentStylePairDataset:
    """Zipped content/style folders with training augmentation: two
    :class:`ImageFolderDataset`s, seeded ``seed`` and ``seed + 1``, as long
    as the longer one; item ``i`` takes each folder's ``i`` modulo its
    length, as (content, style) float32 arrays; ``device`` reads both
    folders' JPEGs, as :class:`ImageFolderDataset`'s does."""

    def __init__(self, content_dir: str, style_dir: str, shorter_side: int = 300,
                 crop: int = 256, seed: int = 0, device="cpu"):
        self.content = ImageFolderDataset(content_dir, shorter_side, crop, seed, device=device)
        self.style = ImageFolderDataset(style_dir, shorter_side, crop, seed + 1, device=device)

    def __len__(self) -> int:
        return max(len(self.content), len(self.style))

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        c, _ = self.content[idx % len(self.content)]
        s, _ = self.style[idx % len(self.style)]
        return c, s


class CenterCropDataset:
    """Eval images: resize shorter side + deterministic center crop."""

    def __init__(self, img_dir: str, shorter_side: int = 300, crop: int = 256, *,
                 device="cpu"):
        self.paths = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir) if is_img(f))
        self.shorter_side = shorter_side
        self.crop = crop
        self.device = device

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, str]:
        img = load_image(self.paths[idx], self.device)
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
                 synthesis: bool = False, seed: int = 0, device="cpu"):
        self.synthesis = synthesis
        self.device = device
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
        style = load_image(spath, self.device)
        if self.style_size:
            style = resize_shorter_side(style, self.style_size)
        style = _to_float(style)
        if self.synthesis:
            content = self.rng.random(style.shape, dtype=np.float32)
            name = os.path.basename(cpath).rsplit(".", 1)[0] + ".jpg"
        else:
            content = load_image(cpath, self.device)
            if self.content_size:
                content = resize_shorter_side(content, self.content_size)
            content = _to_float(content)
            name = (os.path.basename(cpath).rsplit(".", 1)[0] + "+" +
                    os.path.basename(spath).rsplit(".", 1)[0] + ".jpg")
        return content, style, name


class Loader:
    """Shuffling, batching, threaded-prefetch iterator over a dataset.

    Decode and augmentation run in a pool of ``num_workers`` threads; up to
    ``prefetch`` ready batches wait in a queue, so the card does not wait on
    the host's decoding. A dataset error is raised on the consumer's side.
    ``shard=(i, n)`` yields part ``i`` of ``n`` equal parts of each batch,
    in order: the ``n`` loaders of a data-parallel group of processes, with
    one ``seed``, draw the same batches and decode each row once.
    """

    def __init__(self, dataset, batch_size: int = 16, *, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8, prefetch: int = 2,
                 seed: int = 0, shard: tuple[int, int] = (0, 1)):
        if batch_size % shard[1]:
            raise ValueError(f"batch_size {batch_size} does not split into {shard[1]} parts")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = shard
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        i, n = self.shard
        rows = self.batch_size // n
        for b in range(len(self)):
            batch = order[b * self.batch_size: (b + 1) * self.batch_size]
            yield batch[i * rows:(i + 1) * rows]

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            """Put with a stop-responsive timeout; False: the consumer left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in self._batches():
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, idxs))
                        first = items[0]
                        if isinstance(first, tuple):
                            batch = tuple(np.stack(col) if isinstance(first[j], np.ndarray)
                                          else list(col)
                                          for j, col in enumerate(zip(*items)))
                        else:
                            batch = np.stack(items)
                        if not _put(batch):
                            return
                    _put(None)
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                _put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)
