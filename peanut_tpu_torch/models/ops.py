"""Bilinear resize and adaptive average pooling as separable matrix
products (port of ``peanut_tpu.models.ops``), matching
``F.interpolate(mode='bilinear')`` for both ``align_corners`` conventions
and ``F.adaptive_avg_pool2d``'s bins.  The weight matrices are the JAX
package's, float32, so a float64 run rounds them as it does.
``resize_nchw`` and ``adaptive_avg_pool`` take the models' NCHW maps;
``resize_bilinear`` is ``resize_nchw`` on NHWC maps."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import upload


@functools.lru_cache(maxsize=256)
def _linear_resize_matrix(in_size: int, out_size: int,
                          align_corners: bool = False) -> np.ndarray:
    """(out, in) interpolation weights matching torch's bilinear resize.
    Cached: the few geometries a run uses; the caller must not write to
    the array."""
    w = np.zeros((out_size, in_size), np.float32)
    if out_size == 1:
        # torch's convention: sample at 0 with align_corners, else at the
        # half-pixel centre
        src = np.array([0.0 if align_corners else
                        (in_size / out_size * 0.5 - 0.5)])
    elif align_corners:
        src = np.linspace(0, in_size - 1, out_size)
    else:
        src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    w[np.arange(out_size), lo] += 1 - frac
    w[np.arange(out_size), hi] += frac
    return w


@functools.lru_cache(maxsize=256)
def _adaptive_pool_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) averaging weights of torch's AdaptiveAvgPool2d bins."""
    w = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)  # ceil
        w[i, start:end] = 1.0 / (end - start)
    return w


def _weights(m: np.ndarray, x: torch.Tensor):
    """The float32 matrix ``m`` on x's device in the type x meets it in:
    as ``jnp.einsum`` promotes, a bfloat16 map is resized in float32."""
    dt = torch.promote_types(x.dtype, torch.float32)
    return upload(m, x.device).to(dt), dt


def _separable_nchw(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray):
    wh, dt = _weights(mh, x)
    ww, _ = _weights(mw, x)
    x = torch.einsum("oh,...hw->...ow", wh, x.to(dt))
    return torch.einsum("ow,...hw->...ho", ww, x)


def resize_nchw(x: torch.Tensor, size,
                align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (..., C, H, W) maps to (..., C, out_h, out_w), in
    the type x is promoted to with float32 (as ``jnp.einsum`` promotes the
    weights: a bfloat16 map is resized in float32)."""
    out_h, out_w = size
    in_h, in_w = x.shape[-2], x.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return x
    return _separable_nchw(x, _linear_resize_matrix(in_h, out_h,
                                                    align_corners),
                           _linear_resize_matrix(in_w, out_w, align_corners))


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """``resize_nchw`` (half-pixel centres) on (..., H, W, C) maps."""
    return resize_nchw(x.movedim(-1, -3), size).movedim(-3, -1)


def _pair(output_size):
    return ((output_size, output_size) if isinstance(output_size, int)
            else tuple(output_size))


def adaptive_avg_pool(x: torch.Tensor, output_size) -> torch.Tensor:
    """Adaptive average pooling of (..., C, H, W) maps (torch's bins), in
    x's type.  A float64 map meets the JAX package's float32 bin weights,
    as ``jnp.einsum`` promotes them; a narrower one goes through
    ``F.adaptive_avg_pool2d``, the same bins without a float32 copy of
    the map."""
    if x.dtype != torch.float64:
        return F.adaptive_avg_pool2d(x, output_size)
    oh, ow = _pair(output_size)
    return _separable_nchw(x, _adaptive_pool_matrix(x.shape[-2], oh),
                           _adaptive_pool_matrix(x.shape[-1], ow))
