from .agent import PeanutAgent
from .batched_runtime import BatchedNavRuntime, DeviceState
from .planner import MotionPlanner
from .state import NavAgentState

__all__ = ["BatchedNavRuntime", "DeviceState", "MotionPlanner",
           "NavAgentState", "PeanutAgent"]
