"""Training checkpoints (port of the native-checkpoint half of
``peanut_tpu.core.checkpoint``), ``torch.save`` in place of orbax.

A checkpoint is a directory ``work_dir/iter_N`` holding:

* ``model.pth``: ``{"state_dict": ..., "meta": {"iter": N}}``, the model's
  state dict under mmseg's parameter names (mmcv's layout), which
  ``PredictionModel(NavConfig(pred_model_wts=".../model.pth"))`` and
  ``models.checkpoint.load_torch_state_dict`` read;
* ``train_state.pth``: the optimizer's state dict and the step;
* ``STEP``: the step as text, as the JAX package writes it.

Writes are atomic: the files go to a temporary directory beside the target,
which then replaces it by a rename, so a run cut mid-write leaves the
previous checkpoint whole and ``find_latest_checkpoint`` never sees a torn
one.  The files are this program's own output, read back as trusted input.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch

MODEL_FILE = "model.pth"
STATE_FILE = "train_state.pth"


def _cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, state, step: Optional[int] = None) -> str:
    """Write ``state`` (a ``prediction.train.TrainState``) to the directory
    ``path`` atomically, replacing one that is there.  Returns the path."""
    path = os.path.abspath(path)
    step = state.step if step is None else step
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".", dir=parent)
    try:
        torch.save({"state_dict": _cpu(state.model.state_dict()),
                    "meta": {"iter": step}},
                   os.path.join(tmp, MODEL_FILE))
        torch.save({"optimizer": _cpu(state.optimizer.state_dict()),
                    "step": step}, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, "STEP"), "w") as f:
            f.write(str(step))
        if os.path.isdir(path):
            old = tempfile.mkdtemp(prefix=os.path.basename(path) + ".old.",
                                   dir=parent)
            os.replace(path, os.path.join(old, "ckpt"))
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def load_model_state(path: str, model: torch.nn.Module) -> int:
    """Load the model half of the checkpoint directory ``path`` into
    ``model`` (strict: every parameter and statistic, nothing else), as
    serving a trained model needs.  Returns the checkpoint's iteration."""
    saved = torch.load(os.path.join(path, MODEL_FILE), map_location="cpu",
                       weights_only=False)
    model.load_state_dict(saved["state_dict"], strict=True)
    return int(saved["meta"]["iter"])


def load_checkpoint(path: str, state) -> int:
    """Restore the checkpoint directory ``path`` into ``state`` in place
    (the model's parameters and statistics, the optimizer's moments and
    counts, the step; ``load_state_dict`` puts each on the device the
    state lives on).  Returns the step."""
    load_model_state(path, state.model)
    train = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=False)
    state.optimizer.load_state_dict(train["optimizer"])
    state.step = int(train["step"])
    return state.step


def find_latest_checkpoint(work_dir: str) -> Optional[str]:
    """The ``iter_N`` directory of ``work_dir`` with the largest N, or
    None (mmseg's find_latest_checkpoint, for resume)."""
    if not os.path.isdir(work_dir):
        return None
    cands = [d for d in os.listdir(work_dir)
             if d.startswith("iter_") and d[5:].isdigit()
             and os.path.isdir(os.path.join(work_dir, d))]
    if not cands:
        return None
    return os.path.join(work_dir, max(cands, key=lambda d: int(d[5:])))
