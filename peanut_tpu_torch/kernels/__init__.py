from .grid_sample import affine_grid, grid_sample, pose_warp_grids
from .morphology import (
    disk,
    binary_dilation,
    binary_erosion,
    DEFAULT_CROSS,
)
from .splat import splat_feat_nd
from .fmm import eikonal_distance, masked_fill_unreachable

__all__ = [
    "affine_grid",
    "grid_sample",
    "pose_warp_grids",
    "disk",
    "binary_dilation",
    "binary_erosion",
    "DEFAULT_CROSS",
    "splat_feat_nd",
    "eikonal_distance",
    "masked_fill_unreachable",
]
