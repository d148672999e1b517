"""Unseen-target prediction model, inference (torch port of
``peanut_tpu.prediction.model``).

Twin of PEANUT's PEANUT_Prediction_Model (nav/agent/prediction.py:140-158):
a PSPNet-R50-v1c over the partial 14-channel semantic map emitting 6
per-category probability maps as sigmoid(raw logits).  PEANUT's mmcv test
pipeline (MultiScaleFlipAug at ratio 1.0, identity normalisation) reduces
to the model's inference on the model's device: one whole-image forward
(PEANUT's config), or sliding windows where the model's ``test_cfg`` says
``mode="slide"``, as the JAX package's ``model.inference`` runs it.
``get_prediction_sharded`` runs the same inference with the map's height
sharded over a mesh axis (``models.sharded``): the whole forward, or the
sliding windows over the sharded map.

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
from ..core import spatial
from ..core.mesh import axis_devices
from ..models.pspnet import build_segmentor, peanut_prediction_config
from ..models.encoder_decoder import EncoderDecoder
from ..models.mmseg_import import load_mmseg_checkpoint, load_mmseg_state
from ..models.sharded import forward_rows, slide_rows


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
        runtime's trigger ticks): the model's inference in the serving
        type (its sliding windows where ``test_cfg`` says so, else the
        whole forward), the logits into the sigmoid in float32."""
        x = maps.to(self.dtype)
        logits = (self.model.slide_inference(x) if self.model.slides
                  else self.model(x))
        return torch.sigmoid(logits.float())

    def get_prediction_batch(self, full_maps) -> np.ndarray:
        """(B, C, H, W) host maps -> (B, 6, H, W), one forward for all
        episodes."""
        maps = upload(np.asarray(full_maps, np.float32), self.device)
        return self.infer(maps).cpu().numpy()

    @torch.no_grad()
    def get_prediction_sharded(self, full_map: np.ndarray, mesh,
                               axis: str = "spatial") -> np.ndarray:
        """``get_prediction`` with the map's height sharded over the mesh
        axis ``axis`` (the other axes at index 0): (C, H, W) -> (6, H, W)
        float32 probabilities on the host.  Each device of the axis holds
        a block of rows (uneven where they do not divide) and computes
        them in the model's type, taking the halo rows each convolution
        reaches from the shards that hold them (``models.sharded.
        forward_rows``); the model's parameters are read where they lie,
        copied to a shard on another device.  A model whose ``test_cfg``
        slides runs its windows over the sharded map
        (``models.sharded.slide_rows``), each shard summing the logits
        over its own rows; the logits meet the sigmoid in float32 on each
        shard."""
        devices = axis_devices(mesh, axis)
        x = torch.as_tensor(np.asarray(full_map, np.float32)[None])
        rows = spatial.shard(x.to(self.dtype), devices)
        logits = (slide_rows(self.model, rows) if self.model.slides
                  else forward_rows(self.model, rows, train=False))
        return np.concatenate([torch.sigmoid(b.float())[0].cpu().numpy()
                               for b in logits.blocks], axis=1)
