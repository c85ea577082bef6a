"""Device time a step of the kernels launched under the autograd engine's
backward nodes (``autograd::engine::evaluate_function``, by the profiler's
host-op correlation), ms a step."""
from benchlib.shares import per_item_ms


def read(r: dict):
    return per_item_ms(r, "backward_s")
