"""Minimal Torch7 (.t7) binary deserializer.

The port's copy of the reference package's ``utils/t7reader.py``, with every
guard it has against hostile files (truncations, hostile tensor geometry,
the stride-0 memory bomb): a bad file raises ``EOFError`` or ``ValueError``,
never reads out of bounds, hangs or allocates without bound. numpy on the
host only: no tensor goes to any device.

The reference reads its teacher VGG weights from Torch7 Lua checkpoints via
``torch.utils.serialization.load_lua`` (model_original.py:26), an API removed
from torch after 0.4.1. This is a from-scratch reimplementation of the subset
of the Torch7 binary serialization format needed to extract conv weights from
``nn.Sequential`` models: numbers, strings, tables, tensors and storages, with
reference memoization.

Format (all little-endian):
  object   := int32 type-tag, then payload
  tag 0    nil
  tag 1    number        (float64)
  tag 2    string        (int32 len + bytes)
  tag 3    table         (int32 heap-index, int32 count, count * (key, value))
  tag 4    torch object  (int32 heap-index, version/class strings, payload)
  tag 5    boolean       (int32)
  tag 6/7/8 function     (int32 len + dump + upvalue table) — skipped
Tensors serialize as (int32 ndim, int64 sizes[ndim], int64 strides[ndim],
int64 storageOffset(1-based), storage-object); storages as (int64 count,
raw elements).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any

import numpy as np

__all__ = ["load_t7", "read_t7_conv_layers", "T7Object"]

_TYPE_NIL = 0
_TYPE_NUMBER = 1
_TYPE_STRING = 2
_TYPE_TABLE = 3
_TYPE_TORCH = 4
_TYPE_BOOLEAN = 5
_TYPE_FUNCTION = 6
_TYPE_RECUR_FUNCTION = 8
_TYPE_LEGACY_RECUR_FUNCTION = 7

_STORAGE_DTYPES = {
    "torch.DoubleStorage": (np.dtype("<f8"), 8),
    "torch.FloatStorage": (np.dtype("<f4"), 4),
    "torch.HalfStorage": (np.dtype("<f2"), 2),
    "torch.LongStorage": (np.dtype("<i8"), 8),
    "torch.IntStorage": (np.dtype("<i4"), 4),
    "torch.ShortStorage": (np.dtype("<i2"), 2),
    "torch.CharStorage": (np.dtype("i1"), 1),
    "torch.ByteStorage": (np.dtype("u1"), 1),
    # GPU-saved checkpoints: Torch7 serializes Cuda*Storage with the same
    # wire layout as the host storage of the element type (cutorch's
    # THCStorage copies to host on write). A model saved without :float()
    # (the reference's teachers WERE saved from CPU, but third-party .t7s
    # often aren't) must parse, not crash.
    "torch.CudaStorage": (np.dtype("<f4"), 4),
    "torch.CudaDoubleStorage": (np.dtype("<f8"), 8),
    "torch.CudaHalfStorage": (np.dtype("<f2"), 2),
    "torch.CudaLongStorage": (np.dtype("<i8"), 8),
    "torch.CudaIntStorage": (np.dtype("<i4"), 4),
    "torch.CudaByteStorage": (np.dtype("u1"), 1),
}
_TENSOR_CLASSES = {
    "torch.DoubleTensor", "torch.FloatTensor", "torch.HalfTensor",
    "torch.LongTensor", "torch.IntTensor", "torch.ShortTensor",
    "torch.CharTensor", "torch.ByteTensor", "torch.CudaTensor",
    "torch.CudaDoubleTensor", "torch.CudaHalfTensor", "torch.CudaLongTensor",
    "torch.CudaIntTensor", "torch.CudaByteTensor",
}

# fuzz-hardening caps: a hostile few-KB file can claim arbitrary dimension
# counts / sizes; everything must fail with EOFError/ValueError, never an
# out-of-bounds read (as_strided is unchecked!), OOM, or hang. The BYTE cap
# matters for stride-0 views, which stay inside a tiny storage while
# claiming astronomically many elements — .copy() would materialize them.
_MAX_NDIM = 32
_MAX_TENSOR_BYTES = 1 << 30  # 1 GiB; the real teachers' largest tensor is ~19 MB


@dataclass
class T7Object:
    """A deserialized non-tensor torch class instance (e.g. an nn module)."""
    torch_type: str
    attrs: dict = field(default_factory=dict)

    def __getitem__(self, key):
        return self.attrs[key]

    def get(self, key, default=None):
        return self.attrs.get(key, default)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.memo: dict[int, Any] = {}

    def _take(self, n: int) -> bytes:
        if n < 0:
            raise ValueError(f"negative length {n} in t7 stream")
        b = self.data[self.pos: self.pos + n]
        if len(b) != n:
            raise EOFError("truncated t7 file")
        self.pos += n
        return b

    def int32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def int64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def float64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def string(self) -> str:
        n = self.int32()
        return self._take(n).decode("utf-8", errors="replace")

    def int64s(self, n: int) -> list[int]:
        if n < 0:
            raise ValueError(f"negative count {n} in t7 stream")
        return list(struct.unpack(f"<{n}q", self._take(8 * n)))

    # ---- object graph ----

    def obj(self) -> Any:
        tag = self.int32()
        if tag == _TYPE_NIL:
            return None
        if tag == _TYPE_NUMBER:
            v = self.float64()
            return int(v) if v.is_integer() else v
        if tag == _TYPE_STRING:
            return self.string()
        if tag == _TYPE_BOOLEAN:
            return self.int32() == 1
        if tag == _TYPE_TABLE:
            return self._table()
        if tag == _TYPE_TORCH:
            return self._torch()
        if tag in (_TYPE_FUNCTION, _TYPE_RECUR_FUNCTION, _TYPE_LEGACY_RECUR_FUNCTION):
            return self._function(tag)
        raise ValueError(f"unknown t7 type tag {tag} at offset {self.pos - 4}")

    def _table(self) -> dict:
        index = self.int32()
        if index in self.memo:
            return self.memo[index]
        out: dict = {}
        self.memo[index] = out
        count = self.int32()
        for _ in range(count):
            k = self.obj()
            v = self.obj()
            out[k] = v
        return out

    def _torch(self) -> Any:
        index = self.int32()
        if index in self.memo:
            return self.memo[index]
        version = self.string()
        if version.startswith("V "):
            cls = self.string()
        else:
            cls = version  # pre-versioning files
        if cls in _TENSOR_CLASSES:
            placeholder = {}
            self.memo[index] = placeholder
            arr = self._tensor()
            self.memo[index] = arr
            return arr
        if cls in _STORAGE_DTYPES:
            arr = self._storage(cls)
            self.memo[index] = arr
            return arr
        obj = T7Object(cls)
        self.memo[index] = obj
        payload = self.obj()
        if isinstance(payload, dict):
            obj.attrs = payload
        else:
            obj.attrs = {"_payload": payload}
        return obj

    def _tensor(self) -> np.ndarray | None:
        ndim = self.int32()
        if ndim < 0 or ndim > _MAX_NDIM:
            raise ValueError(f"implausible tensor ndim {ndim}")
        sizes = self.int64s(ndim)
        strides = self.int64s(ndim)
        offset = self.int64() - 1
        storage = self.obj()
        if storage is None or ndim == 0:
            return None
        # every check below guards np.as_strided, which performs NO bounds
        # checking of its own: a hostile size/stride/offset combination would
        # otherwise read arbitrary process memory (or "just" OOM in .copy())
        if not isinstance(storage, np.ndarray):
            raise ValueError(
                f"tensor storage is {type(storage).__name__}, not a storage")
        if offset < 0 or any(s < 0 for s in sizes):
            raise ValueError("negative tensor size/offset")
        if any(s == 0 for s in sizes):
            return np.zeros(tuple(sizes), storage.dtype)
        n_elems = 1
        for s in sizes:
            n_elems *= s
            if n_elems * storage.dtype.itemsize > _MAX_TENSOR_BYTES:
                raise ValueError(
                    f"implausible tensor: {n_elems} elements of "
                    f"{storage.dtype} exceed the {_MAX_TENSOR_BYTES}-byte cap")
        lo = offset + sum((sz - 1) * st for sz, st in zip(sizes, strides) if st < 0)
        hi = offset + sum((sz - 1) * st for sz, st in zip(sizes, strides) if st > 0)
        if lo < 0 or hi >= storage.size:
            raise ValueError(
                f"tensor view [{lo}, {hi}] escapes its {storage.size}-element storage")
        return np.lib.stride_tricks.as_strided(
            storage[offset:],
            shape=tuple(sizes),
            strides=tuple(s * storage.dtype.itemsize for s in strides),
        ).copy()

    def _storage(self, cls: str) -> np.ndarray:
        dtype, width = _STORAGE_DTYPES[cls]
        n = self.int64()
        if n < 0:
            raise ValueError(f"negative storage count {n}")
        arr = np.frombuffer(self._take(n * width), dtype=dtype)
        if dtype == np.dtype("<f2"):  # half: widen once at the boundary
            return arr.astype(np.float32)
        return arr.copy()

    def _function(self, tag: int):
        size = self.int32()
        self._take(size)  # skip the Lua bytecode dump
        self.obj()  # upvalues table
        return None


def load_t7(path: str) -> Any:
    """Deserialize a .t7 file into python structures (tensors -> numpy)."""
    with open(path, "rb") as f:
        return _Reader(f.read()).obj()


def _iter_modules(node: Any):
    """Depth-first walk over nn containers yielding leaf modules in order."""
    if isinstance(node, T7Object):
        modules = node.get("modules")
        if isinstance(modules, dict) and modules:
            for i in sorted(k for k in modules if isinstance(k, (int, float))):
                yield from _iter_modules(modules[i])
        else:
            yield node


def read_t7_conv_layers(path: str) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """Extract (weight OIHW, bias) per flat module index from an nn.Sequential.

    Indices are 0-based over the flattened module list, matching the
    reference's ``t7_model.get(i)`` access (model_original.py:452-486).
    Non-parametric modules (ReLU, pads, pools) occupy indices but yield no
    entry.
    """
    root = load_t7(path)
    layers: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for i, mod in enumerate(_iter_modules(root)):
        w, b = mod.get("weight"), mod.get("bias")
        if isinstance(w, np.ndarray) and isinstance(b, np.ndarray):
            if w.ndim == 2:  # SpatialConvolution stored flattened (out, in*kh*kw)
                kh = int(mod.get("kH", 1) or 1)
                kw_ = int(mod.get("kW", 1) or 1)
                if kh <= 0 or kw_ <= 0:
                    raise ValueError(f"module {i}: bad kernel dims {kh}x{kw_}")
                cin = int(mod.get("nInputPlane", 0) or w.shape[1] // (kh * kw_))
                if cin * kh * kw_ != w.shape[1]:
                    raise ValueError(
                        f"module {i}: flattened weight {w.shape} inconsistent "
                        f"with nInputPlane={cin}, kH={kh}, kW={kw_}")
                w = w.reshape(w.shape[0], cin, kh, kw_)
            layers[i] = (np.asarray(w, np.float64), np.asarray(b, np.float64))
    return layers
