"""The whole training step's share of the card's published peak, %: the
traced window's needed FLOPs (benchlib/counts.py: wct_se_flops) over the
window and the peak of the configuration's dtype."""
from benchlib.shares import mfu_pct as read  # noqa: F401
