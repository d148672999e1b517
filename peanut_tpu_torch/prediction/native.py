"""ctypes binding to the native (C++/OpenMP) data-pipeline kernels of
``native/map_pipeline.cc`` (port of ``peanut_tpu.prediction.native``).

The source is the JAX package's; the port compiles its own copy of the
library (``cc -O3 -fopenmp``) at first use into
``build/peanut_tpu_torch/native/<source hash>/`` (gitignored) and never
writes ``native/*.so``, which belongs to the JAX package.  A missing
compiler or a failed build raises: nothing falls back to the python
chain by itself (``dataset.training_pipeline(use_native=False)`` asks for
it).  These are host kernels: the card's machine has no cv2, so the
trainer augments through ``augment_sample`` there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SRC = _REPO / "native" / "map_pipeline.cc"
BUILD_ROOT = _REPO / "build" / "peanut_tpu_torch" / "native"
CC_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def _build() -> Path:
    key = hashlib.sha256(SRC.read_bytes() + " ".join(CC_FLAGS).encode())
    out = BUILD_ROOT / key.hexdigest()[:16] / "libmap_pipeline.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["cc", *CC_FLAGS, str(SRC), "-lstdc++", "-o",
                               str(tmp)], capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("cc not found: the native data pipeline "
                           f"({SRC}) builds at first use") from e
    if proc.returncode != 0:
        raise RuntimeError(f"cc failed on {SRC}:\n{proc.stderr}")
    os.replace(tmp, out)            # atomic publish
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            fp = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i, f = ctypes.c_int, ctypes.c_float
            lib.augment_sample.argtypes = [fp, fp] + [i] * 8 + [f, f, fp, fp]
            lib.augment_sample.restype = None
            lib.extract_timestep.argtypes = [u8p] + [i] * 7 + [fp, fp]
            lib.extract_timestep.restype = None
            _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def augment_sample(img: np.ndarray, gt: np.ndarray, crop: int, crop_y: int,
                   crop_x: int, flip: bool, angle_deg: float,
                   pad_val: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Pad -> crop -> flip -> rotate in one inverse-mapped pass (bilinear
    for ``img``, nearest for ``gt``): (H, W, C) float32 -> (crop, crop,
    C)."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    gt = np.ascontiguousarray(gt, np.float32)
    if img.ndim != 3 or gt.ndim != 3 or img.shape[:2] != gt.shape[:2]:
        raise ValueError(f"(H, W, C) img and gt of one size, got "
                         f"{img.shape} / {gt.shape}")
    h, w, c_img = img.shape
    img_out = np.empty((crop, crop, c_img), np.float32)
    gt_out = np.empty((crop, crop, gt.shape[2]), np.float32)
    lib.augment_sample(_fptr(img), _fptr(gt), h, w, c_img, gt.shape[2],
                       crop, crop_y, crop_x, int(flip), angle_deg, pad_val,
                       _fptr(img_out), _fptr(gt_out))
    return img_out, gt_out


def extract_timestep(maps: np.ndarray, t_idx: int, goal_lo: int = 4,
                     goal_hi: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 (T, C, H, W) -> (img (H, W, C) / 255, gt (H, W, goal_hi -
    goal_lo) of the last timestep, masked to the cells unexplored at
    ``t_idx``)."""
    lib = _load()
    maps = np.ascontiguousarray(maps, np.uint8)
    if maps.ndim != 4 or not 0 <= t_idx < maps.shape[0] \
            or not 0 <= goal_lo < goal_hi <= maps.shape[1]:
        raise ValueError(f"(T, C, H, W) maps with t_idx < T and goal "
                         f"channels inside C, got {maps.shape}, t_idx "
                         f"{t_idx}, goals [{goal_lo}, {goal_hi})")
    t, c, h, w = maps.shape
    img = np.empty((h, w, c), np.float32)
    gt = np.empty((h, w, goal_hi - goal_lo), np.float32)
    lib.extract_timestep(maps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         t, c, h, w, t_idx, goal_lo, goal_hi, _fptr(img),
                         _fptr(gt))
    return img, gt
