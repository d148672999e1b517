from .model import PredictionModel

__all__ = ["PredictionModel"]
