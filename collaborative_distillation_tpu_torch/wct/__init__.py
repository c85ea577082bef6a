from .engine import WCTEngine, stage_style_stats, stylize_stage
from .slab import SlabCascade, build_fused_slab_cascade, receptive_radius

__all__ = ["WCTEngine", "stage_style_stats", "stylize_stage", "SlabCascade",
           "build_fused_slab_cascade", "receptive_radius"]
