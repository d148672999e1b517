"""High-level API (port of ``peanut_tpu.apis``; mmseg apis parity).

The names and call shapes of the reference's mmseg.apis, so zoo user code
ports directly:

    from peanut_tpu_torch import apis
    bundle = apis.init_segmentor(
        "configs/upernet/upernet_r50_512x1024_80k_cityscapes.py")
    probs = apis.inference_segmentor(bundle, hwc_image)   # (19, H, W)

The model runs on the card unless ``device`` says otherwise (no card and
no ``device`` raises).  ``train_segmentor`` wraps the training CLI as the
JAX package's does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from . import resolve_device, upload


@dataclass
class SegmentorBundle:
    model: torch.nn.Module
    cfg: Dict[str, Any]
    device: torch.device

    def __call__(self, img, **kw):
        return inference_segmentor(self, img, **kw)


def init_segmentor(config: Union[str, Dict], checkpoint: Optional[str] = None,
                   input_size: int = 512, seed: int = 0,
                   device=None) -> SegmentorBundle:
    """A segmentor from a config file or dict (its ``model`` entry, or the
    dict itself), in eval mode on ``device`` (``resolve_device``).  Weights
    (mmseg apis/inference.py:12-40 parity):

    * ``checkpoint`` a ``.pth`` / ``.pt`` file: an mmseg state dict,
      loaded strictly; names the port does not have (the zoo's heads are
      named after their flax modules, not mmseg's) raise KeyError, as the
      JAX package's ``convert_encoder_decoder_state`` does;
    * ``checkpoint`` a directory: the port's own training checkpoint
      (``core/checkpoint.py``);
    * none: random weights from ``seed`` with flax's initialisers, as the
      JAX package's ``init_segmentor_params`` draws them.

    The port's modules know their shapes, except the parameters that flax
    shapes from the input at init (``layers.InputShaped``): PSAHead's
    masks, which span the relative positions of one feature size, BEiT's
    relative-position tables, which span its patch grid, and MAE's
    positional embedding, one per patch.  They are bound here, by one
    forward at the size the bundle serves (the slide crop, else the
    config's ``crop_size``, else an ``input_size`` square, the dummy input
    JAX's ``init_segmentor_params`` shapes flax's variables from), so a
    request never changes the model; BEiT and MAE then serve that size
    alone, and another raises ValueError, as the JAX package's variables
    do not fit it.
    """
    from .core.checkpoint import load_model_state
    from .core.config_file import load_config
    from .models.builder import build_segmentor
    from .models.layers import needs_binding
    from .models.mmseg_import import load_mmseg_checkpoint, load_mmseg_state

    device = resolve_device(device)
    cfg = load_config(config) if isinstance(config, str) else dict(config)
    model_cfg = cfg["model"] if "model" in cfg else cfg
    if checkpoint and os.path.isdir(checkpoint):
        model = build_segmentor(model_cfg)
        load_model_state(checkpoint, model)
    elif checkpoint:
        model = build_segmentor(model_cfg)
        try:
            load_mmseg_state(model, load_mmseg_checkpoint(checkpoint))
        except RuntimeError as e:
            raise KeyError(f"checkpoint {checkpoint!r} does not match the "
                           f"port's parameters: {e}") from e
    else:
        model = build_segmentor(model_cfg, seed=seed)
    model = model.to(device).eval()
    if needs_binding(model):
        test_cfg = model_cfg.get("test_cfg") or {}
        h, w = (test_cfg["crop_size"] if test_cfg.get("mode") == "slide"
                else cfg.get("crop_size", (input_size, input_size)))
        in_ch = model_cfg["backbone"].get("in_channels", 3)
        with torch.no_grad():
            model(torch.zeros(1, in_ch, h, w, device=device))
    return SegmentorBundle(model=model, cfg=cfg, device=device)


@torch.no_grad()
def inference_segmentor(bundle: SegmentorBundle, img, logits: bool = False):
    """Whole or slide inference (the config's ``test_cfg``) on one image.

    img: (H, W, C) or (C, H, W) numpy array (CHW when the first axis has
    at most 32 entries and the last more, the JAX package's rule).  Returns
    the sigmoid probabilities (PEANUT passthrough semantics) or, with
    ``logits``, the raw logits: a float32 numpy (C_out, H, W)."""
    arr = np.asarray(img, np.float32)
    if arr.shape[0] <= 32 and arr.shape[-1] > 32:      # CHW -> HWC
        arr = arr.transpose(1, 2, 0)
    dtype = next(bundle.model.parameters()).dtype
    x = upload(np.ascontiguousarray(arr)[None], bundle.device).to(dtype)
    out = bundle.model.inference(x)[0].permute(2, 0, 1).float()
    if not logits:
        out = torch.sigmoid(out)
    return out.cpu().numpy()


def train_segmentor(config: Union[str, Dict], data_root: str,
                    work_dir: str, device=None, **overrides):
    """Config-driven training (mmseg apis/train.py:71's shape), as the JAX
    package's: ``cli.train_prediction_model.main`` on ``--data_root``,
    ``--work_dir`` and one ``--key value`` an override, on ``device``
    (the card unless ``"cpu"``); returns its ``TrainState``.  Like the
    reference, it does not pass ``config`` on, so it trains PEANUT's
    PSPNet whatever the config names (give ``config=...`` among the
    overrides to train a zoo config; ``distributed=1`` trains data
    parallel, one process a card under torchrun)."""
    from .cli.train_prediction_model import main as train_main

    argv = ["--data_root", data_root, "--work_dir", work_dir]
    for k, v in overrides.items():
        argv += [f"--{k}", str(v)]
    return train_main(argv, device=device)
