from .camera import CameraMatrix, get_camera_matrix, point_cloud_from_depth
from .rotation import get_r_matrix
from .pose import (
    get_l2_distance,
    get_rel_pose_change,
    get_new_pose,
    integrate_pose,
    integrate_pose_np,
    threshold_poses,
)
from .transforms import transform_camera_view, transform_pose

__all__ = [
    "CameraMatrix",
    "get_camera_matrix",
    "point_cloud_from_depth",
    "get_r_matrix",
    "get_l2_distance",
    "get_rel_pose_change",
    "get_new_pose",
    "integrate_pose",
    "integrate_pose_np",
    "threshold_poses",
    "transform_camera_view",
    "transform_pose",
]
