"""Bilinear resize as two matrix products (port of the resize of
``peanut_tpu.models.ops``), matching ``F.interpolate(mode='bilinear',
align_corners=False)``, the convention the port uses.  Layout NHWC, as the
JAX package's."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import upload


@functools.lru_cache(maxsize=64)
def _linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) interpolation weights matching torch's bilinear resize
    (half-pixel centres).  Cached: the few geometries a run uses; the
    caller must not write to the array."""
    w = np.zeros((out_size, in_size), np.float32)
    src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    w[np.arange(out_size), lo] += 1 - frac
    w[np.arange(out_size), hi] += frac
    return w


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) maps to (..., out_h, out_w, C).

    The float32 weight matrices meet ``x`` in the promoted type, as
    ``jnp.einsum`` promotes them: a bfloat16 image is resized in float32."""
    out_h, out_w = size
    in_h, in_w = x.shape[-3], x.shape[-2]
    if (in_h, in_w) == (out_h, out_w):
        return x
    dt = torch.promote_types(x.dtype, torch.float32)
    wh = upload(_linear_resize_matrix(in_h, out_h), x.device).to(dt)
    ww = upload(_linear_resize_matrix(in_w, out_w), x.device).to(dt)
    x = torch.einsum("oh,...hwc->...owc", wh, x.to(dt))
    return torch.einsum("ow,...hwc->...hoc", ww, x)
