"""Small rasterization helpers (host numpy; a copy of
``peanut_tpu.utils.drawing``).

draw_line matches PEANUT's visited-path rasterizer
(nav/agent/utils/visualization.py:19-24): 26 rounded samples along the
segment, each stamped as a w-wide square.
"""

from __future__ import annotations

import numpy as np


def draw_line(start, end, mat, steps: int = 25, w: int = 1) -> np.ndarray:
    for i in range(steps + 1):
        x = int(np.rint(start[0] + (end[0] - start[0]) * i / steps))
        y = int(np.rint(start[1] + (end[1] - start[1]) * i / steps))
        mat[x - w:x + w, y - w:y + w] = 1
    return mat


def get_contour_points(pos, origin, size: int = 12) -> np.ndarray:
    """Arrowhead contour for the agent marker (visualization.py:5-16)."""
    x, y, o = pos
    pt1 = (int(x) + origin[0], int(y) + origin[1])
    pt2 = (int(x + size / 1.5 * np.cos(o + np.pi * 4 / 3)) + origin[0],
           int(y + size / 1.5 * np.sin(o + np.pi * 4 / 3)) + origin[1])
    pt3 = (int(x + size * np.cos(o)) + origin[0],
           int(y + size * np.sin(o)) + origin[1])
    pt4 = (int(x + size / 1.5 * np.cos(o - np.pi * 4 / 3)) + origin[0],
           int(y + size / 1.5 * np.sin(o - np.pi * 4 / 3)) + origin[1])
    return np.array([pt1, pt2, pt3, pt4])
