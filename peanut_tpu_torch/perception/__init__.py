from .depth import preprocess_depth
from .segmentation import (Segmenter, GroundTruthSegmenter, FullGTSegmenter,
                           ZeroSegmenter, build_segmenter)

__all__ = [
    "preprocess_depth",
    "Segmenter",
    "GroundTruthSegmenter",
    "FullGTSegmenter",
    "ZeroSegmenter",
    "build_segmenter",
]
