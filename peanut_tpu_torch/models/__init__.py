from .mask_rcnn import MaskRCNN, PIXEL_MEAN_BGR, load_d2_state
from .d2_import import flax_to_d2_state

__all__ = ["MaskRCNN", "PIXEL_MEAN_BGR", "load_d2_state", "flax_to_d2_state"]
