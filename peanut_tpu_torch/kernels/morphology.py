"""Binary morphology as convolution thresholding (torch ``conv2d``).

Port of ``peanut_tpu.kernels.morphology``: a disk dilation is
``conv2d(image, footprint) > 0``, erosion its dual.  Inputs and footprints
are 0/1, so the sums are small integers and exact even where cuDNN runs f32
convolutions in TF32.  The numpy twins serve the host planner's small grids.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def disk(radius) -> np.ndarray:
    """Disk footprint, identical to ``skimage.morphology.disk(radius)``."""
    r = int(radius)
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    return (x ** 2 + y ** 2 <= r ** 2).astype(np.uint8)


# skimage's default footprint: connectivity-1 cross (3x3 diamond)
DEFAULT_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=np.uint8)


def conv_same(x: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """(..., H, W) correlation with a 2-D footprint and zero padding."""
    lead = x.shape[:-2]
    k = torch.as_tensor(np.asarray(footprint), dtype=torch.float32,
                        device=x.device)[None, None]
    out = F.conv2d(x.reshape((-1, 1) + x.shape[-2:]).float(), k,
                   padding=(k.shape[-2] // 2, k.shape[-1] // 2))
    return out.reshape(lead + out.shape[-2:])


def binary_dilation(image: torch.Tensor, footprint=None) -> torch.Tensor:
    """Matches skimage.morphology.binary_dilation; returns bool."""
    if footprint is None:
        footprint = DEFAULT_CROSS
    return conv_same((image > 0).float(), footprint) > 0.5


def binary_erosion(image: torch.Tensor, footprint=None) -> torch.Tensor:
    """Matches skimage.morphology.binary_erosion; returns bool."""
    if footprint is None:
        footprint = DEFAULT_CROSS
    return conv_same((image <= 0).float(), footprint) < 0.5


# ----------------------------------------------------------------------
# Host (numpy) twins for the planner's small-grid state machines
# ----------------------------------------------------------------------

def _np_hits(image, footprint):
    """Count of set pixels under the footprint at each location (zero pad)."""
    img = np.asarray(image) > 0
    fp = np.asarray(footprint) > 0
    kh, kw = fp.shape
    ph, pw = kh // 2, kw // 2
    padded = np.zeros((img.shape[0] + 2 * ph, img.shape[1] + 2 * pw),
                      dtype=np.int32)
    padded[ph:ph + img.shape[0], pw:pw + img.shape[1]] = img
    out = np.zeros(img.shape, dtype=np.int32)
    for dy, dx in np.argwhere(fp):
        out += padded[dy:dy + img.shape[0], dx:dx + img.shape[1]]
    return out


def np_binary_dilation(image, footprint=None) -> np.ndarray:
    if footprint is None:
        footprint = DEFAULT_CROSS
    return _np_hits(image, footprint) > 0


def np_binary_erosion(image, footprint=None) -> np.ndarray:
    if footprint is None:
        footprint = DEFAULT_CROSS
    fp = np.asarray(footprint) > 0
    return _np_hits(image, footprint) == int(fp.sum())
