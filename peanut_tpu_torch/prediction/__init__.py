from .model import PredictionModel
# the datasets and wrappers register themselves in DATASETS when imported
from . import dataset, image_dataset, wrappers  # noqa: F401

__all__ = ["PredictionModel"]
