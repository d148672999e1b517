from .mask_rcnn import MaskRCNN, PIXEL_MEAN_BGR, load_d2_state
from .d2_import import flax_to_d2_state
# the zoo's own modules of the light families (each registers its classes)
from . import hrnet, mobilenet, unet  # noqa: F401
# the timm adapter registers TIMMBackbone
from . import timm_adapter  # noqa: F401
# the losses register themselves in LOSSES
from . import losses, losses_extra  # noqa: F401

__all__ = ["MaskRCNN", "PIXEL_MEAN_BGR", "load_d2_state", "flax_to_d2_state"]
