"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build happens at
first use, in ``build/torch_kernels/<hash>/`` at the repository root, keyed by
a hash of the sources and flags, so a fresh checkout builds itself and an
unchanged one loads what it built before. One ``nvcc`` per source runs in
parallel, then one links them.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

__all__ = ["library", "check", "build_dir", "last_build"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB = "libcd_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: every pointer and the stream as void*, so ctypes never cuts
# a 64-bit address to a 32-bit int.
_SIGNATURES = {
    "cd_conv3x3_reflect": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "cd_conv1x1_bias": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
    "cd_sum_gram": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "cd_max_pool_2x2": [_P, _P, _I, _I, _I, _I, _P],
    "cd_upsample_nearest_2x": [_P, _P, _I, _I, _I, _I, _P],
    "cd_halo_exchange_rows": [_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _P],
}

_lock = threading.Lock()
_lib = None
last_build: dict = {}  # {"dir", "seconds", "built", "log"} of the load in this process


def _sources() -> list[str]:
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith((".cu", ".cuh")))


def build_dir() -> str:
    h = hashlib.sha256(" ".join(_ARCH + _FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(_REPO, "build", "torch_kernels", h.hexdigest()[:16])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source "
                       "at first use and need the CUDA toolkit")


def _compile(out_dir: str) -> str:
    """Compile every .cu into ``out_dir``/``_LIB``; returns the compiler log."""
    nvcc = _nvcc()
    units = [s for s in _sources() if s.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out_dir)) as tmp:
        procs = []
        for src in units:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *_ARCH, *_FLAGS, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {os.path.basename(src)}\n{out}")
            if p.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(log))
        tmp_lib = os.path.join(tmp, _LIB)
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", tmp_lib, *(o for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.makedirs(out_dir, exist_ok=True)
        text = "\n".join(log)
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(text)
        os.replace(tmp_lib, os.path.join(out_dir, _LIB))  # atomic publish
    return text


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = build_dir()
        path = os.path.join(out_dir, _LIB)
        t0 = time.perf_counter()
        built = not os.path.exists(path)
        if built:
            os.makedirs(os.path.dirname(out_dir), exist_ok=True)
            log = _compile(out_dir)
        else:
            log = ""
            log_path = os.path.join(out_dir, "build.log")
            if os.path.exists(log_path):
                with open(log_path) as f:
                    log = f.read()
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        last_build.update(dir=out_dir, built=built, log=log,
                          seconds=time.perf_counter() - t0)
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch "
                           f"(cudaGetLastError)")
