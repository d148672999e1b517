"""CascadeEncoderDecoder, its serving half (port of
``peanut_tpu.models.cascade``), registered in ``SEGMENTORS``.

A list of ``num_stages`` decode heads (``decode_head0``, ...): stage 0 on
the features, every later stage also on the previous stage's logits
(OCRHead takes them as its soft regions).  A PointHead last runs
PointRend's subdivision at inference, with static shapes: the logits
upsampled ``scale_factor`` times, the ``subdivision_num_points`` most
uncertain cells chosen by ``boxes.top_k`` (stable: ``torch.topk`` does
not order ties as ``jax.lax.top_k`` does), re-classified from the fine
features and the upsampled logits, and written back; ``subdivision_steps``
rounds.  Training (the PointRend training pass) is ROADMAP A13 part 5.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from ..registry import HEADS, SEGMENTORS
from .boxes import top_k
from .encoder_decoder import HEAD_DROP, EncoderDecoder, build_component
from .heads import OCRHead, resize_like
from .heads_zoo import PointHead


@SEGMENTORS.register()
class CascadeEncoderDecoder(EncoderDecoder):
    """EncoderDecoder's backbone, neck, auxiliary head, slide and whole
    inference over a list of decode heads.  (The JAX package's cascade
    runs whole inference whatever ``test_cfg`` says; no config of the zoo
    asks it for slide.)"""

    def __init__(self, num_stages: int, backbone: Dict[str, Any],
                 decode_head: Sequence[Dict[str, Any]], **kw):
        if len(decode_head) != num_stages:
            raise ValueError(f"{num_stages} stages, {len(decode_head)} "
                             "decode heads")
        super().__init__(backbone, list(decode_head), **kw)

    def build_heads(self, decode_head) -> None:
        self.num_stages = len(decode_head)
        for i, cfg in enumerate(decode_head):
            head = build_component(HEADS, cfg, HEAD_DROP)
            if i and isinstance(head, OCRHead):
                head.soft_regions = None      # it takes the prior logits
            self.add_module(f"decode_head{i}", head)

    def heads(self):
        return [getattr(self, f"decode_head{i}")
                for i in range(self.num_stages)]

    def _run_stages(self, feats):
        """Every stage before a point head: the last one's logits, at the
        head's resolution."""
        prev = None
        for head in self.heads():
            if isinstance(head, PointHead):
                break
            prev = (head(feats) if prev is None
                    else head(feats, prev_logits=prev))
        return prev

    def subdivide(self, feats, logits: torch.Tensor):
        """The point head's rounds over the coarse logits: the refined
        logits and the flat indices of the cells each round re-classified
        ((B, P) each, most uncertain first)."""
        head = self.heads()[-1]
        cfg = self.test_cfg
        num_points = int(cfg.get("subdivision_num_points", 1024))
        steps = int(cfg.get("subdivision_steps", 2))
        scale = int(cfg.get("scale_factor", 2))
        refined, chosen = logits, []
        for _ in range(steps):
            h2, w2 = refined.shape[-2] * scale, refined.shape[-1] * scale
            refined = resize_like(refined, (h2, w2), self.align_corners)
            b, k = refined.shape[:2]
            unc = PointHead.uncertainty(refined).reshape(b, h2 * w2)
            _, idx = top_k(unc, min(num_points, h2 * w2))
            ys = torch.div(idx, w2, rounding_mode="floor").float()
            xs = (idx % w2).float()
            pts = torch.stack([(xs + 0.5) / w2, (ys + 0.5) / h2], dim=-1)
            point_logits = head(feats, refined, pts)          # (B, K, P)
            flat = refined.reshape(b, k, h2 * w2).scatter(
                2, idx[:, None, :].expand(b, k, -1),
                point_logits.to(refined.dtype))
            refined = flat.reshape(b, k, h2, w2)
            chosen.append(idx)
        return refined, chosen

    def encode_decode(self, img: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> logits resized to the input, after the point
        head's subdivision where the last stage is one."""
        feats = self.extract_feat(img)
        logits = self._run_stages(feats)
        if isinstance(self.heads()[-1], PointHead):
            logits = self.subdivide(feats, logits)[0]
        return self._resize(logits, img.shape[-2:])

    def forward(self, img: torch.Tensor, train: Optional[bool] = None,
                with_aux: bool = False, generator=None) -> torch.Tensor:
        """The serving forward: ``encode_decode`` in eval mode.  Training
        a cascade is ROADMAP A13 part 5."""
        if train:
            raise NotImplementedError(
                "training a CascadeEncoderDecoder (the PointRend training "
                "pass) is the zoo's training half, ROADMAP A13 part 5")
        return self.encode_decode(img)
