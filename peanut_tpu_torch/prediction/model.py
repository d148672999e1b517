"""Unseen-target prediction model, inference (torch port of
``peanut_tpu.prediction.model``).

Twin of PEANUT's PEANUT_Prediction_Model (nav/agent/prediction.py:140-158):
a PSPNet-R50-v1c over the partial 14-channel semantic map emitting 6
per-category probability maps as sigmoid(raw logits).  PEANUT's mmcv test
pipeline (MultiScaleFlipAug at ratio 1.0, identity normalisation) reduces
to one whole-image forward, which is what runs here, on the model's device.

Weights: ``model`` (an EncoderDecoder, taken over), else ``state_dict``
(mmseg keys), else the checkpoint at ``cfg.pred_model_wts``.  Unlike the
JAX package, a missing checkpoint raises FileNotFoundError naming the path:
nothing falls back to random weights (a caller who wants them passes
``model=build_segmentor(..., seed=s)``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device, upload
from ..config import NavConfig
from ..models.pspnet import build_segmentor, peanut_prediction_config
from ..models.encoder_decoder import EncoderDecoder
from ..models.mmseg_import import load_mmseg_checkpoint, load_mmseg_state


class PredictionModel:
    def __init__(self, cfg: NavConfig, state_dict=None,
                 model: Optional[EncoderDecoder] = None, device=None):
        """``device``: ``resolve_device`` (the card unless ``"cpu"``).
        ``cfg.serve_bf16`` runs weights and activations in bfloat16; the
        logits meet the sigmoid in float32."""
        self.cfg = cfg
        if model is None:
            if state_dict is None:
                state_dict = load_mmseg_checkpoint(cfg.pred_model_wts)
            model = load_mmseg_state(build_segmentor(peanut_prediction_config(
                in_channels=4 + cfg.num_sem_categories, num_classes=6)),
                state_dict)
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if cfg.serve_bf16 else torch.float32
        self.model = model.to(device=self.device, dtype=self.dtype).eval()

    def get_prediction(self, full_map: np.ndarray) -> np.ndarray:
        """full_map: (C, H, W) float -> (6, H, W) per-category
        probabilities."""
        return self.get_prediction_batch(np.asarray(full_map)[None])[0]

    @torch.no_grad()
    def infer(self, maps: torch.Tensor) -> torch.Tensor:
        """(K, C, H, W) tensor on the model's device -> (K, 6, H, W) float32
        probabilities on it, without a host round trip (the batched
        runtime's trigger ticks): the forward in the serving type, the
        logits into the sigmoid in float32."""
        return torch.sigmoid(self.model(maps.to(self.dtype)).float())

    def get_prediction_batch(self, full_maps) -> np.ndarray:
        """(B, C, H, W) host maps -> (B, 6, H, W), one forward for all
        episodes."""
        maps = upload(np.asarray(full_maps, np.float32), self.device)
        return self.infer(maps).cpu().numpy()
