from .fake import FakeNavEnv, BatchedFakeNavEnv

__all__ = ["FakeNavEnv", "BatchedFakeNavEnv"]
