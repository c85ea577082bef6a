"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from the
root of the repository (about two minutes). They put the benchmark's own
folder and the root on the path, as ``run.py`` does."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)
