"""Torch checkpoint files as {name: numpy array} (the port's copy of
``peanut_tpu.core.checkpoint.load_torch_state_dict``).

Handles the wrappers the PEANUT checkpoints use: bare state dicts, mmcv's
``{'state_dict': ..., 'meta': ...}`` (the PSPNet at ``pred_model_wts``),
detectron2's ``{'model': ..., ...}`` (the Mask R-CNN at ``seg_model_wts``)
and ``module.`` prefixes from DataParallel saves.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def load_torch_state_dict(path: str, what: str,
                          cfg_field: str) -> Dict[str, np.ndarray]:
    """The checkpoint at ``path`` as {name: numpy array}.  A missing file
    raises FileNotFoundError naming the path, the model (``what``) and the
    config field it came from.  The file is the configured model
    checkpoint, a trusted input, read as the JAX package reads it."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{what} weights not found at {path!r} (cfg.{cfg_field}); put "
            "the checkpoint there or pass state_dict= or model=")
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        if "state_dict" in obj:
            obj = obj["state_dict"]
        elif "model" in obj and isinstance(obj["model"], dict):
            obj = obj["model"]
    return {k[len("module."):] if k.startswith("module.") else k:
            np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in obj.items() if hasattr(v, "shape")}
