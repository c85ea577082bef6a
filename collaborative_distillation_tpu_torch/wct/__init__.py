from .engine import WCTEngine, stage_style_stats, stylize_stage

__all__ = ["WCTEngine", "stage_style_stats", "stylize_stage"]
