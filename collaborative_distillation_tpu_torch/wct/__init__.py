from .engine import (WCTEngine, stage_style_stats, stylize_cascade_fn, stylize_stage,
                     stylize_stage_pwct)
from .slab import SlabCascade, build_fused_slab_cascade, receptive_radius

__all__ = ["WCTEngine", "stage_style_stats", "stylize_stage", "stylize_stage_pwct",
           "stylize_cascade_fn", "SlabCascade", "build_fused_slab_cascade", "receptive_radius"]
