"""Profiling: named spans and counters inside the port, and a trace exporter.

* :func:`span` — a named range around one layer's work (``cd.cascade``,
  ``cd.conv3x3``, ...; PERF.md §3 lists them). While a ``torch.profiler``
  records, the span is a host op in the profiler's own timeline, on the
  clock of the kernels and copies it launches: they are correlated to it as
  to any aten op, so the profiler's ``device_time_total`` of the range is
  their device time, its nested spans' included. Otherwise it is one shared
  null context: a flag test, no allocation, no dispatcher call.
* :func:`counters` — a flat snapshot of the port's counts: the kernel
  launches, the pinned host buffers the host boundary makes, and the WCT's
  decompositions by path.
* :func:`trace` — context manager that profiles the enclosed block (host
  and, on a card, CUDA activity) and writes a Chrome trace (``trace.json``,
  open in Perfetto or ``chrome://tracing``) into a directory; the spans
  show in it. Beside it, ``counters.json``: the counters' change over the
  block.
"""

from __future__ import annotations

import contextlib
import json
import os

import torch

__all__ = ["span", "counters", "trace"]

_NULL = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def _range(name: str):
    """torch.profiler.record_function's range at function scope: the
    kernels a user-scope range launches are tied to it only by the
    profiler's separate user correlation, which leaves the port's own
    kernels (launched through ctypes, under no aten op) out of its
    device_time_total. A private torch class, looked up only while a
    profiler records, so an untraced port does not depend on it."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is None:
        raise RuntimeError("cd. spans need torch._C._profiler._RecordFunctionFast, "
                           f"which torch {torch.__version__} lacks")
    return fast(name)


def span(name: str):
    """A range named ``name`` in the running profiler's timeline, or the
    shared null context when no profiler records. Spans nest: a span's
    parent is the span that encloses it on the same thread."""
    if not _recording():
        return _NULL
    return _range(name)


def counters() -> dict[str, int]:
    """The port's counts now, read where the code counting them keeps them
    (no copy):

    * ``launches``: the launches of ``ops.cuda.KERNELS`` and
      ``ops.cuda.BF16_KERNELS`` (the loader's ``DATA_KERNELS`` apart, as
      there);
    * ``pinned_buffers``, ``pinned_bytes``: the pinned host buffers made
      through :func:`.transfer.pinned_empty` (``push``'s staging, ``fetch``'s
      output, the slab path's band buffers), and their bytes;
    * ``eigh_kernel``, ``eigh_library``: the covariances the WCT decomposed
      with the ``sym_eigh`` kernel and with ``torch.linalg.eigh``
      (:data:`..ops.wct_transform.EIGH`).

    Take two snapshots and subtract."""
    from ..ops.cuda import BF16_KERNELS, KERNELS
    from ..ops.wct_transform import EIGH
    from .transfer import PINNED
    return {"launches": sum(k.launches for k in KERNELS + BF16_KERNELS),
            "pinned_buffers": PINNED["buffers"], "pinned_bytes": PINNED["bytes"],
            "eigh_kernel": EIGH["kernel"], "eigh_library": EIGH["library"]}


@contextlib.contextmanager
def trace(logdir: str | None):
    """Profile the enclosed block into ``logdir``/trace.json, and write the
    change of :func:`counters` over it to ``logdir``/counters.json (no-op
    when logdir is falsy)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    before = counters()
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        after = counters()
        with open(os.path.join(logdir, "counters.json"), "w") as f:
            json.dump({k: after[k] - before[k] for k in after}, f, indent=1)
