"""Log lines and a throughput meter for the CLIs.

:class:`LogPrinter` writes timestamped lines to a file and optionally the
screen; :class:`Throughput` is a running MPix/s and s/step meter. The
training bookkeeping (loss meter, experiment directories) belongs to the
training slice.
"""

from __future__ import annotations

import os
import time

__all__ = ["LogPrinter", "Throughput"]


class LogPrinter:
    """Timestamped logger writing to a file and optionally the screen."""

    def __init__(self, log_file=None, exp_id: str = "", to_screen: bool = True):
        self.file = log_file
        self.exp_id = exp_id
        self.to_screen = to_screen

    def __call__(self, msg: str) -> None:
        line = f"[{self.exp_id[-6:]} {os.getpid()} {time.strftime('%Y/%m/%d-%H:%M:%S')}] {msg}"
        if self.file is not None:
            print(line, file=self.file, flush=True)
        if self.to_screen or self.file is None:
            print(line, flush=True)


class Throughput:
    """Running MPix/s + s/step meter."""

    def __init__(self):
        self.t0 = time.time()
        self.pixels = 0
        self.steps = 0

    def tick(self, pixels: int) -> None:
        self.pixels += pixels
        self.steps += 1

    def report(self) -> str:
        dt = max(time.time() - self.t0, 1e-9)
        return f"{self.pixels / dt / 1e6:.2f} MPix/s, {dt / max(self.steps, 1):.2f} s/step"
