from .profiler import StageTimer

__all__ = ["StageTimer"]
