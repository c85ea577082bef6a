"""JPEG on the card: nvJPEG decode into device planes and encode from them.

The counterpart, for a CUDA device, of :mod:`.native_codec` (libjpeg on the
host): the same entry points and the same None contract, on torch CUDA
tensors and the caller's current stream. ``csrc/nvjpeg_codec.cpp`` is a
small C interface over nvJPEG, built at first use with ``nvcc ... -shared
-lnvjpeg`` (cudart linked statically, as the kernel library's is) into
``build/torch_kernels/nvjpeg-<hash of the source and flags>/`` at the
repository root and loaded with ctypes. The toolkit is found as the kernels
find ``nvcc``; nvJPEG ships with it (``include/nvjpeg.h``,
``lib64/libnvjpeg.so``), and the library is loaded from there (rpath).

* :func:`decode_jpeg_yuv420`: an even-sized baseline 4:2:0 file -> its own
  planes, Y (H, W) and CbCr (H/2, W/2, 2) uint8 on the card, with no
  colour conversion (``NVJPEG_OUTPUT_YUV``; nvJPEG gives Cb and Cr apart,
  interleaved here on the card), the layouts of
  ``native_codec.decode_jpeg_yuv420``.
* :func:`decode_jpeg`: any file nvJPEG reads (other samplings, odd sizes,
  progressive, grey) -> (H, W, 3) uint8 RGB on the card (``NVJPEG_OUTPUT_RGBI``).
* :func:`encode_jpeg_yuv420`: device 4:2:0 planes -> baseline JPEG bytes.
* :func:`encode_jpeg`: (H, W, 3) RGB on the card -> JPEG bytes, through the
  port's own ``rgbf_to_yuv420_device`` and then the planes' encode, so the
  pixel maths is the port's, not nvJPEG's.

nvJPEG's backend is its default: the Huffman decode runs on the host, the
IDCT and the rest on the card. One handle a device for the process; the
decoder and encoder states are not shared between threads: each call takes
a free state from a pool, kept for the process (a server's handler threads
live one request each: a state per thread would rebuild its buffers every
request). Where the
toolkit, the build, the card or nvJPEG fail, every function returns None,
:func:`available` is False and :func:`unavailable_reason` says why. Nothing
falls back to libjpeg. The C calls release the GIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager

import numpy as np
import torch

from . import jpeg_header
from .native_codec import MAX_DECODE_PIXELS

__all__ = ["available", "unavailable_reason", "decode_jpeg", "decode_jpeg_yuv420",
           "encode_jpeg", "encode_jpeg_yuv420", "memory", "version", "build_dir",
           "build_command", "cuda_home"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "nvjpeg_codec.cpp")
_LIB = "libcd_nvjpeg.so"
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PL = ctypes.POINTER(ctypes.c_longlong)
# C signatures (every pointer and the stream as void*)
_SIGNATURES = {
    "cd_nvjpeg_version": [_P],
    "cd_nvjpeg_state_create": [_I, _P],
    "cd_nvjpeg_decode": [_P, _P, _L, _I, _P, _L, _P, _L, _P, _L, _P],
    "cd_nvjpeg_encode_yuv420": [_P, _P, _L, _P, _L, _P, _L, _I, _I, _I, _P, _PL],
    "cd_nvjpeg_encode_retrieve": [_P, _P, _PL, _P],
    "cd_nvjpeg_memory": [_P, _I],
}
_STATUS = {1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG", 4: "JPEG_NOT_SUPPORTED",
           5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED", 7: "ARCH_MISMATCH",
           8: "INTERNAL_ERROR", 9: "IMPLEMENTATION_NOT_SUPPORTED", 10: "INCOMPLETE_BITSTREAM"}
_DATA_ERRORS = (3, 4, 10)   # the file, not the codec: the None contract
_CUDA_BASE = 1000

_lock = threading.Lock()
_lib = None
_reason: str | None = None   # why nvJPEG is unavailable, once it was tried
_pool: dict[int, list[int]] = {}   # device index -> free states
_pool_lock = threading.Lock()
last_build: dict = {}   # {"dir", "built", "command", "log"} of the load in this process


class _DataError(RuntimeError):
    """nvJPEG refused the file (bad, unsupported or incomplete data)."""


def cuda_home() -> str:
    """The CUDA toolkit: ``CUDA_HOME``, else ``nvcc``'s parent directory."""
    if os.environ.get("CUDA_HOME"):
        return os.environ["CUDA_HOME"]
    from ..ops.cuda import _build
    return os.path.dirname(os.path.dirname(os.path.realpath(_build._nvcc())))


def build_command(home: str, out: str) -> list[str]:
    """The ``nvcc`` line that builds the shim at ``out`` against the
    toolkit at ``home``."""
    lib64 = os.path.join(home, "lib64")
    return [os.path.join(home, "bin", "nvcc"), *_FLAGS, _SRC, "-o", out,
            "-I" + os.path.join(home, "include"), "-L" + lib64, "-lnvjpeg",
            "-Xlinker", "-rpath=" + lib64]


def build_dir() -> str:
    """``build/torch_kernels/nvjpeg-<hash of the source and flags>``."""
    h = hashlib.sha256(" ".join(_FLAGS + ["-lnvjpeg"]).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_REPO, "build", "torch_kernels", "nvjpeg-" + h.hexdigest()[:16])


def _build() -> str:
    """The shared object's path, compiled first if this source has none."""
    out_dir = build_dir()
    so = os.path.join(out_dir, _LIB)
    home = cuda_home()
    last_build.update(dir=out_dir, built=False, command=build_command(home, so), log="")
    if not os.path.exists(so):
        header = os.path.join(home, "include", "nvjpeg.h")
        if not os.path.exists(header):
            raise RuntimeError(f"the CUDA toolkit at {home} has no include/nvjpeg.h")
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = build_command(home, tmp)
        nvcc = cmd[0] if os.path.exists(cmd[0]) else shutil.which("nvcc")
        try:
            r = subprocess.run([nvcc, *cmd[1:]], capture_output=True, text=True, timeout=300)
        except (OSError, TypeError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"nvcc could not run: {e}") from e
        if r.returncode:
            raise RuntimeError(f"nvcc exited {r.returncode}: {(r.stderr or r.stdout).strip()}")
        os.replace(tmp, so)   # atomic publish
        last_build.update(built=True, log=(r.stdout + r.stderr).strip())
    return so


def _load():
    global _lib, _reason
    if _lib is not None or _reason is not None:
        return _lib
    with _lock:
        if _lib is not None or _reason is not None:
            return _lib
        try:
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available")
            lib = ctypes.CDLL(_build())
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, ctypes.c_int
            st = ctypes.c_void_p()   # one state: the handle loads on the current card
            dev = torch.cuda.current_device()
            _check(lib, lib.cd_nvjpeg_state_create(dev, ctypes.byref(st)), "create")
            _pool.setdefault(dev, []).append(st.value)
            _lib = lib
        except (OSError, RuntimeError, AttributeError) as e:
            _reason = f"nvJPEG unavailable: {e}"
    return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str | None:
    """None where nvJPEG loaded; else why not (the compiler's output, the
    missing header or card, nvJPEG's status)."""
    _load()
    return _reason


def _check(lib, rc: int, what: str) -> None:
    if rc == 0:
        return
    if rc in _DATA_ERRORS:
        raise _DataError(_STATUS[rc])
    if rc >= _CUDA_BASE:
        raise RuntimeError(f"nvJPEG {what}: CUDA error {rc - _CUDA_BASE}")
    raise RuntimeError(f"nvJPEG {what}: status {rc} ({_STATUS.get(rc, 'unknown')})")


@contextmanager
def _state(lib, device: torch.device):
    """A decoder/encoder state of ``device`` that no other thread holds."""
    dev = device.index if device.index is not None else torch.cuda.current_device()
    with _pool_lock:
        free = _pool.setdefault(dev, [])
        st = free.pop() if free else None
    if st is None:
        p = ctypes.c_void_p()
        _check(lib, lib.cd_nvjpeg_state_create(dev, ctypes.byref(p)), "state")
        st = p.value
    try:
        yield st
    finally:
        with _pool_lock:
            _pool[dev].append(st)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"nvJPEG runs on a CUDA device, not {device}")
    return device


def _header(data: bytes, max_pixels: int | None):
    hdr = jpeg_header.parse(data)
    limit = MAX_DECODE_PIXELS if max_pixels is None else max_pixels
    if hdr is None or hdr.width * hdr.height > limit:
        return None
    return hdr


def _decode(lib, data: bytes, device, rgb: bool, planes) -> bool:
    """Run one decode into ``planes`` [(tensor, pitch)] * 3; False where
    nvJPEG refused the data."""
    (c0, p0), (c1, p1), (c2, p2) = planes
    buf = ctypes.c_char_p(bytes(data))
    with _state(lib, device) as st:
        try:
            _check(lib, lib.cd_nvjpeg_decode(st, buf, len(data), int(rgb), c0, p0, c1, p1,
                                             c2, p2, _stream(device)), "decode")
        except _DataError:
            return False
    return True


def decode_jpeg_yuv420(data: bytes, device="cuda", *, max_pixels: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor] | None:
    """JPEG bytes -> (Y (H, W) u8, CbCr (H/2, W/2, 2) u8) on ``device``,
    the planes the file stores. None when nvJPEG is unavailable, the file
    is not an even-sized baseline 4:2:0 JPEG, its claimed size exceeds
    ``max_pixels`` (default MAX_DECODE_PIXELS), or nvJPEG refuses it."""
    device = _cuda(device)
    lib = _load()
    hdr = None if lib is None else _header(data, max_pixels)
    if hdr is None or not hdr.planes_ok:
        return None
    h, w = hdr.height, hdr.width
    y = torch.empty((h, w), dtype=torch.uint8, device=device)
    cb = torch.empty((h // 2, w // 2), dtype=torch.uint8, device=device)
    cr = torch.empty_like(cb)
    if not _decode(lib, data, device, False,
                   [(y.data_ptr(), w), (cb.data_ptr(), w // 2), (cr.data_ptr(), w // 2)]):
        return None
    return y, torch.stack([cb, cr], dim=-1)


def decode_jpeg(data: bytes, device="cuda", *, max_pixels: int | None = None
                ) -> torch.Tensor | None:
    """JPEG bytes -> (H, W, 3) uint8 RGB on ``device``, for any file nvJPEG
    reads. None when nvJPEG is unavailable, the header is bad, the claimed
    size exceeds ``max_pixels`` (default MAX_DECODE_PIXELS), or nvJPEG
    refuses the data."""
    device = _cuda(device)
    lib = _load()
    hdr = None if lib is None else _header(data, max_pixels)
    if hdr is None:
        return None
    out = torch.empty((hdr.height, hdr.width, 3), dtype=torch.uint8, device=device)
    if not _decode(lib, data, device, True,
                   [(out.data_ptr(), 3 * hdr.width), (None, 0), (None, 0)]):
        return None
    return out


def _encode(lib, y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, w: int, h: int,
            quality: int) -> bytes:
    device = y.device
    n = ctypes.c_longlong(0)
    with _state(lib, device) as st:
        _check(lib, lib.cd_nvjpeg_encode_yuv420(
            st, y.data_ptr(), y.stride(0), cb.data_ptr(), cb.stride(0), cr.data_ptr(),
            cr.stride(0), w, h, int(quality), _stream(device), ctypes.byref(n)), "encode")
        out = np.empty(n.value, np.uint8)
        _check(lib, lib.cd_nvjpeg_encode_retrieve(st, out.ctypes.data, ctypes.byref(n),
                                                  _stream(device)), "retrieve")
    return out[:n.value].tobytes()


def encode_jpeg_yuv420(y: torch.Tensor, cbcr: torch.Tensor, quality: int = 95) -> bytes | None:
    """Device 4:2:0 planes, Y (H, W) and CbCr (H/2, W/2, 2) uint8 -> baseline
    JPEG bytes; None when nvJPEG is unavailable or the planes are not that."""
    lib = _load()
    if (lib is None or y.device.type != "cuda" or cbcr.device != y.device
            or y.dtype != torch.uint8 or cbcr.dtype != torch.uint8 or y.dim() != 2):
        return None
    h, w = y.shape
    if h % 2 or w % 2 or tuple(cbcr.shape) != (h // 2, w // 2, 2):
        return None
    return _encode(lib, y.contiguous(), cbcr[..., 0].contiguous(), cbcr[..., 1].contiguous(),
                   w, h, quality)


def encode_jpeg(rgb: torch.Tensor, quality: int = 95) -> bytes | None:
    """(H, W, 3) uint8 RGB on the card -> baseline 4:2:0 JPEG bytes, the
    planes made by the port's ``rgbf_to_yuv420_device`` (odd edges repeated
    first, as libjpeg pads a partial block); None when nvJPEG is unavailable
    or the array is not that."""
    from ..utils.colorspace import rgbf_to_yuv420_device
    lib = _load()
    if (lib is None or rgb.device.type != "cuda" or rgb.dtype != torch.uint8
            or rgb.dim() != 3 or rgb.shape[2] != 3):
        return None
    h, w = rgb.shape[:2]
    x = rgb[None].float() / 255.0
    if h % 2 or w % 2:
        x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, w % 2, 0, h % 2),
                                    mode="replicate").permute(0, 2, 3, 1)
    y, cbcr = rgbf_to_yuv420_device(x)
    return _encode(lib, y[0].contiguous(), cbcr[0, ..., 0].contiguous(),
                   cbcr[0, ..., 1].contiguous(), w, h, quality)


def memory(reset_peak: bool = False) -> dict | None:
    """nvJPEG's own allocations in bytes (``device``, ``device_peak``,
    ``pinned``, ``pinned_peak``), which ``torch.cuda.max_memory_allocated``
    cannot see; None when nvJPEG is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = (ctypes.c_longlong * 4)()
    lib.cd_nvjpeg_memory(out, int(reset_peak))
    return dict(zip(("device", "device_peak", "pinned", "pinned_peak"), out))


def version() -> str | None:
    """nvJPEG's ``major.minor.patch``; None when it is unavailable."""
    lib = _load()
    if lib is None:
        return None
    v = (ctypes.c_int * 3)()
    _check(lib, lib.cd_nvjpeg_version(v), "version")
    return ".".join(map(str, v))
