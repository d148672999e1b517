from .batched_runtime import BatchedNavRuntime, DeviceState

__all__ = ["BatchedNavRuntime", "DeviceState"]
