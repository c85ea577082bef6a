"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from the
root of the repository (about three minutes). They put the benchmark's own
folder and the root on the path, as ``run.py`` does.

Each cell's test data is a file of its own, ``tests/cells/<cell>.json``:
``mix``, the mix's keys overridden to a size a CPU test can hold (large
enough that every stage's covariance is of full rank, and on the cell's own
path); ``limits`` (optional), limits read at that size, ``{"why": ...,
"values": {number: limit}}``, where the cell's own cannot hold there;
``not_correct``, the runs that must come out not correct: ``"control"``
(the reference in the next precision down in the program's place), always,
and every fault of ``control.FAULTS`` that the cell's driver lists in its
``HELD_TO``."""

import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
CELLS_DIR = os.path.join(BENCH_DIR, "tests", "cells")
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)


def held_to(cell: str, bench_dir: str = BENCH_DIR) -> tuple:
    """The faults of ``control.FAULTS`` that the cell's driver can have: its
    ``HELD_TO``, which every driver lists."""
    from benchlib import manifest
    c = manifest.load_cell(cell, bench_dir)
    faults = getattr(c.driver(), "HELD_TO", None)
    if faults is None:
        raise ValueError(f"drivers/{c.mix['driver']}.py lists no HELD_TO: the faults of "
                         f"control.FAULTS that its cells can have")
    return tuple(faults)


def cell_case(cell: str, cells_dir: str = CELLS_DIR, faults: tuple | None = None) -> dict:
    """``tests/cells/<cell>.json``, checked: a missing file is named; a run
    in ``not_correct`` that is neither the control nor a fault of
    ``control.FAULTS`` is refused, and so is a list without the control or
    without a fault the cell's driver is held to (``faults``, by default
    its driver's ``HELD_TO``)."""
    from control import FAULTS
    path = os.path.join(cells_dir, cell + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"cell {cell} has no test data: add {path} with its tiny "
                                f"'mix' and the runs that are 'not_correct'")
    with open(path) as f:
        case = json.load(f)
    runs = case.get("not_correct", [])
    unknown = [r for r in runs if r != "control" and r not in FAULTS]
    if faults is None:
        faults = held_to(cell, os.path.dirname(os.path.dirname(cells_dir)))
    missing = [r for r in ("control", *faults) if r not in runs]
    if unknown or missing:
        raise ValueError(f"{path}: not_correct {runs} must name 'control' and the driver's "
                         f"faults {list(faults)}, of control.FAULTS "
                         f"({', '.join(sorted(FAULTS))}); unknown: {unknown}, "
                         f"missing: {missing}")
    return case
