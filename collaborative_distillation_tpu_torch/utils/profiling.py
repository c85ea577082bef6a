"""Profiling hooks: a ``torch.profiler`` trace and a step timer.

* :func:`trace` — context manager that profiles the enclosed block (host
  and, on a card, CUDA activity) and writes a Chrome trace
  (``trace.json``, open in Perfetto or ``chrome://tracing``) into a
  directory;
* :class:`StepTimer` — step timer with percentile reporting.
"""

from __future__ import annotations

import contextlib
import os
import time

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(logdir: str | None):
    """Profile the enclosed block into ``logdir``/trace.json (no-op when
    logdir is falsy)."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    def __init__(self):
        self.samples: list[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.time() - self._t0)

    def report(self) -> str:
        if not self.samples:
            return "no samples"
        s = sorted(self.samples)
        n = len(s)
        return (f"n={n} mean={sum(s)/n*1000:.1f}ms "
                f"p50={s[n//2]*1000:.1f}ms p95={s[min(n-1, int(n*0.95))]*1000:.1f}ms "
                f"min={s[0]*1000:.1f}ms")
