"""Device time a cascade of the kernels launched under
``aten::linalg_eigh`` (found by the profiler's host-op correlation, not by
kernel name), ms an image."""
from benchlib.shares import per_item_ms


def read(r: dict):
    return per_item_ms(r, "eigh_s")
