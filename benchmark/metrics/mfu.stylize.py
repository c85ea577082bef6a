"""The whole cascade's share of the card's published peak, %: the traced
window's needed FLOPs (benchlib/counts.py: cascade_flops, style leg
included, slab margins once) over the window and the peak of the
configuration's dtype."""
from benchlib.shares import mfu_pct as read  # noqa: F401
