"""Share of the traced window in which the card ran nothing (kernels,
copies and sets as the profiler records them): 1 - busy / window, %."""
from benchlib.shares import idle_pct as read  # noqa: F401
