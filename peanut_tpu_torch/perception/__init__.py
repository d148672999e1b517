from .depth import preprocess_depth
from .segmentation import (Segmenter, GroundTruthSegmenter, FullGTSegmenter,
                           ZeroSegmenter, build_segmenter)
from .mask_rcnn_segmenter import MaskRCNNSegmenter

__all__ = [
    "preprocess_depth",
    "Segmenter",
    "GroundTruthSegmenter",
    "FullGTSegmenter",
    "ZeroSegmenter",
    "build_segmenter",
    "MaskRCNNSegmenter",
]
