from .fmm_planner import FMMPlanner, step_mask, step_dist
from .untrap import UnTrapHelper

__all__ = ["FMMPlanner", "step_mask", "step_dist", "UnTrapHelper"]
