"""Log lines, meters and experiment directories for the CLIs.

:class:`LogPrinter` writes timestamped lines to a file and optionally the
screen; :class:`Throughput` is a running MPix/s and s/step meter;
:class:`LossMeter` an EMA of named losses; :class:`Experiment` the training
run's directory (log, checkpoints, reconstruction grids);
:func:`resolve_path` a glob that must match one file, and
:func:`git_code_id` the commit a run was made from.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
import time

__all__ = ["LogPrinter", "LossMeter", "Experiment", "resolve_path", "git_code_id",
           "Throughput"]

_HERE = os.path.dirname(os.path.abspath(__file__))


def resolve_path(pattern: str) -> str:
    """Expand a glob that must match exactly one file ("" stays "")."""
    if not pattern:
        return pattern
    matches = glob.glob(pattern)
    if len(matches) != 1:
        raise FileNotFoundError(
            f"path pattern {pattern!r} matched {len(matches)} entries: {matches[:5]}")
    return matches[0]


def git_code_id() -> str:
    """The short commit id of the checkout this package lies in, or "nogit"
    (stamped into training logs)."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short=8", "HEAD"], capture_output=True, cwd=_HERE,
            text=True, timeout=10).stdout.strip() or "nogit"
    except (OSError, subprocess.SubprocessError):
        return "nogit"


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


class LossMeter:
    """EMA of named losses (``momentum`` 0: the last value)."""

    def __init__(self, momentum: float = 0.0):
        self.momentum = momentum
        self.values: dict[str, float] = {}

    def update(self, name: str, value: float) -> None:
        v = float(value)
        if name in self.values:
            v = self.values[name] * self.momentum + v * (1 - self.momentum)
        self.values[name] = v

    def format(self) -> str:
        # .4g: late-training losses sit well below 1e-3
        return " | ".join(f"{k}: {self.values[k]:.4g}" for k in sorted(self.values))


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

    def reset(self) -> None:
        self.t0 = time.time()
        self.pixels = 0
        self.steps = 0


class Experiment:
    """A training run's directory,
    ``<root>/<timestamp>_<name>/{weights,reconstructed_images}`` (or
    ``Debug_Dir`` with ``debug``), with the launch command and the code id
    at the head of its log (``weights/log_<timestamp>.txt``). ``close``
    closes the log."""

    def __init__(self, project_name: str = "", *, debug: bool = False,
                 root: str = "Experiments", to_screen: bool = True):
        self.time_id = time.strftime("%Y%m%d-%H%M%S")
        self.exp_id = self.time_id
        base = "Debug_Dir" if debug else os.path.join(root, f"{self.exp_id}_{project_name}")
        self.dir = base
        self.images_dir = os.path.join(base, "reconstructed_images")
        self.weights_dir = os.path.join(base, "weights")
        os.makedirs(self.images_dir, exist_ok=True)
        os.makedirs(self.weights_dir, exist_ok=True)
        self.log_path = os.path.join(self.weights_dir, f"log_{self.exp_id}.txt")
        self.log_file = open(self.log_path, "w")
        print(" ".join(["python", *sys.argv]), file=self.log_file, flush=True)
        self.log = LogPrinter(self.log_file, self.exp_id, to_screen)
        self.log(f"CodeID: {git_code_id()}")

    def ckpt_path(self, tag: str = "") -> str:
        return os.path.join(self.weights_dir, f"{self.exp_id}{tag}.npz")

    def image_path(self, epoch: int, step: int) -> str:
        return os.path.join(self.images_dir, f"{self.time_id}_E{epoch}S{step}.jpg")

    def close(self) -> None:
        self.log_file.close()
