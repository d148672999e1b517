"""Episode visualization dashboard (port of
``peanut_tpu.utils.visualization``).

The reference's 1415x600 composite: RGB frame | semantic map with the
prediction overlay | dist-weight and value panels (layout per PEANUT's
nav/agent/utils/visualization.py:27-83 and agent_helper.py:496-621), the
legend drawn programmatically.  Host numpy; cv2 and matplotlib are
imported when a frame is drawn, so the module imports without them.
Panels take numpy arrays or tensors (read back to the host).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..constants import color_palette, map_category_names
from .drawing import get_contour_points


def _host(x) -> np.ndarray:
    """A panel's values as a host array (a tensor is read back)."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def _put_text(img, text, org):
    import cv2

    cv2.putText(img, text, org, cv2.FONT_HERSHEY_DUPLEX, 1, (20, 20, 20), 1,
                cv2.LINE_AA)


def init_vis_image(goal_name: str) -> np.ndarray:
    import cv2

    vis = np.ones((600, 1415, 3), np.uint8) * 255
    _put_text(vis, f"RGB Observation (Target: {goal_name})", (80, 32))
    _put_text(vis, "Semantic Map & Prediction", (750, 32))
    _put_text(vis, "Dist Weight", (1180, 32))
    _put_text(vis, "Value Map", (1185, 560))
    color = (100, 100, 100)
    vis[49, 15:655] = color
    vis[49, 670:1150] = color
    vis[50:530, 14] = color
    vis[50:530, 655] = color
    vis[50:530, 669] = color
    vis[50:530, 1150] = color
    vis[530, 15:655] = color
    vis[530, 670:1150] = color
    vis[50:530, 1164] = color

    # programmatic legend
    x = 30
    for idx, name in map_category_names.items():
        k = (idx + 5) * 3
        c = [int(255 * v) for v in color_palette[k:k + 3]]
        cv2.rectangle(vis, (x, 545), (x + 18, 563), c[::-1], -1)
        cv2.putText(vis, name[:9], (x + 22, 560), cv2.FONT_HERSHEY_SIMPLEX,
                    0.4, (40, 40, 40), 1, cv2.LINE_AA)
        x += 115
    return vis


class EpisodeVisualizer:
    """Builds and dumps the per-step dashboard from the planner's inputs
    and the agent's state."""

    def __init__(self, cfg, rank: int = 0):
        self.cfg = cfg
        self.rank = rank
        self.episode_no = 0

    def reset(self):
        self.episode_no += 1
        self.timestep = 0

    def render(self, planner_inputs: Dict, rgb_vis: np.ndarray,
               collision_map: np.ndarray, visited_vis: np.ndarray,
               stg, target_pred=None, value=None, dd_wt=None,
               goal_name: str = "") -> np.ndarray:
        import cv2
        import matplotlib.cm

        cfg = self.cfg
        self.timestep += 1
        map_pred = planner_inputs["obstacle"]
        exp_pred = planner_inputs["exp_pred"]
        start_x, start_y, start_o, gx1, gx2, gy1, gy2 = \
            planner_inputs["pose_pred"]
        gx1, gx2, gy1, gy2 = int(gx1), int(gx2), int(gy1), int(gy2)
        goal = planner_inputs["goal"]
        sem_map = np.asarray(planner_inputs["sem_map_pred"]).copy()
        local_w, local_h = sem_map.shape

        vis = init_vis_image(goal_name)

        sem_map += 5
        sem_map[collision_map[gx1:gx2, gy1:gy2] == 1] = 14
        if stg is not None and int(stg[0]) < local_w and int(stg[1]) < local_h:
            sem_map[int(stg[0]), int(stg[1])] = 15

        no_cat = sem_map == cfg.num_sem_categories + 4
        map_mask = np.rint(map_pred) == 1
        exp_mask = np.rint(exp_pred) == 1
        vis_mask = visited_vis[gx1:gx2, gy1:gy2] == 1
        sem_map[no_cat] = 0
        sem_map[np.logical_and(no_cat, exp_mask)] = 2
        sem_map[np.logical_and(no_cat, map_mask)] = 1
        sem_map[vis_mask] = 3

        from ..kernels.morphology import disk, np_binary_dilation
        goal_mat = 1 - np_binary_dilation(goal, disk(4)) != True  # noqa: E712
        sem_map[goal_mat == 1] = 4

        pal = (np.array(color_palette).reshape(-1, 3) * 255).astype(np.uint8)
        sem_rgb = pal[np.clip(sem_map, 0, len(pal) - 1)]
        sem_rgb = np.flipud(sem_rgb)[:, :, ::-1]
        sem_rgb = cv2.resize(sem_rgb, (480, 480),
                             interpolation=cv2.INTER_NEAREST)

        rgb_res = cv2.resize(rgb_vis, (640, 480))
        vis[50:530, 15:655] = rgb_res
        vis[50:530, 670:1150] = sem_rgb

        cmap = matplotlib.colormaps["Purples"]

        def panel(data, size):
            data = _host(data)
            normed = (data - np.min(data)) / max(np.ptp(data), 1e-9)
            mapped = (cmap(normed)[::-1, :, [2, 1, 0]] * 255).astype(np.uint8)
            return cv2.resize(mapped, size, interpolation=cv2.INTER_NEAREST)

        if target_pred is not None:
            white = np.where(sem_rgb.sum(axis=2) == 255 * 3)
            overlay = panel(target_pred, (480, 480))
            region = vis[50:530, 670:1150]
            region[white] = overlay[white]
        if dd_wt is not None:
            vis[50:290, 1165:1405] = panel(dd_wt, (240, 240))
        if value is not None:
            vis[290:530, 1165:1405] = panel(value, (240, 240))

        pos = ((start_x * 100.0 / cfg.map_resolution - gy1) * 480 / local_w,
               (local_h - start_y * 100.0 / cfg.map_resolution + gx1)
               * 480 / local_h,
               np.deg2rad(-start_o))
        arrow = get_contour_points(pos, origin=(670, 50))
        color = (int(color_palette[11] * 255), int(color_palette[10] * 255),
                 int(color_palette[9] * 255))
        cv2.drawContours(vis, [arrow], 0, color, -1)
        return vis

    def show_or_dump(self, vis: np.ndarray):
        import cv2

        cfg = self.cfg
        if cfg.visualize == 1:
            cv2.imshow(f"Thread {self.rank}", vis)
            cv2.waitKey(1)
        elif cfg.visualize == 2:
            dump_dir = os.path.join(cfg.dump_location, "dump", cfg.exp_name,
                                    "episodes", f"thread_{self.rank}",
                                    f"eps_{self.episode_no - 1}")
            os.makedirs(dump_dir, exist_ok=True)
            fn = os.path.join(
                dump_dir,
                f"{self.rank}-{self.episode_no - 1}-Vis-{self.timestep}.jpg")
            cv2.imwrite(fn, vis, [cv2.IMWRITE_JPEG_QUALITY, 100])
