"""Share of the traced window of training steps in which the card ran
nothing: 1 - busy / window, %."""
from benchlib.shares import idle_pct as read  # noqa: F401
