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
rounds.  In train mode the forward is the JAX package's ``__call__``:
every stage's logits resized to the input (the train step puts a loss
on each), and PointRend's training pass, the point head on the
``train_cfg.num_points`` most uncertain cells of the coarse logits.
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
    """EncoderDecoder's backbone, neck, auxiliary head and whole inference
    over a list of decode heads.  Inference is whole whatever ``test_cfg``
    says, as the JAX package's cascade runs it (``slides`` is False)."""

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

    @property
    def slides(self) -> bool:
        return False

    def heads(self):
        return [getattr(self, f"decode_head{i}")
                for i in range(self.num_stages)]

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
        logits = self._stage_outputs(feats)[-1]
        if isinstance(self.heads()[-1], PointHead):
            logits = self.subdivide(feats, logits)[0]
        return self._resize(logits, img.shape[-2:])

    def _stage_outputs(self, feats, generator=None):
        """Every stage before a point head, in the module's mode: their
        logits at the heads' resolution."""
        outs, prev = [], None
        for head in self.heads():
            if isinstance(head, PointHead):
                break
            prev = (head(feats, generator) if prev is None
                    else head(feats, generator, prev_logits=prev))
            outs.append(prev)
        return outs

    def point_pass(self, feats, coarse: torch.Tensor):
        """PointRend's training pass (point_head.py forward_train, with a
        deterministic top-k in place of its importance sampling, as in
        the JAX package): the point head's logits (B, K, P) at the
        ``train_cfg.num_points`` (256) most uncertain cells of the coarse
        logits, and those cells' normalised centres (B, P, 2), most
        uncertain first (``boxes.top_k``, stable as inference's)."""
        b, _, ch, cw = coarse.shape
        k = min(int(self.train_cfg.get("num_points", 256)), ch * cw)
        unc = PointHead.uncertainty(coarse).reshape(b, ch * cw)
        _, idx = top_k(unc, k)
        ys = torch.div(idx, cw, rounding_mode="floor").float()
        xs = (idx % cw).float()
        pts = torch.stack([(xs + 0.5) / cw, (ys + 0.5) / ch], dim=-1)
        return self.heads()[-1](feats, coarse, pts), pts

    def forward(self, img: torch.Tensor, train: Optional[bool] = None,
                with_aux: bool = False, generator=None,
                with_points: bool = False):
        """``train`` switches the mode first, as ``EncoderDecoder``'s.  In
        eval mode: the serving forward, ``encode_decode``.  In train mode
        (the JAX package's ``__call__``): the logits of every stage before
        a point head resized to the input, then the auxiliary head's with
        ``with_aux``, as a tuple, or the one tensor when there is one.
        With ``with_points`` (PointRend), the pair (that, {"point_logits":
        (B, K, P), "points": (B, P, 2)}) of ``point_pass``: what flax
        sows into ``intermediates``."""
        if train is not None:
            self.train(train)
        if not self.training:
            return self.encode_decode(img)
        feats = self.extract_feat(img)
        stages = self._stage_outputs(feats, generator)
        hw = img.shape[-2:]
        outs = [self._resize(o, hw) for o in stages]
        if with_aux and self.auxiliary_head is not None:
            outs.append(self._resize(self.auxiliary_head(feats, generator),
                                     hw))
        out = tuple(outs) if len(outs) > 1 else outs[0]
        if not with_points:
            return out
        if not isinstance(self.heads()[-1], PointHead):
            raise ValueError("with_points: the last stage is not a "
                             "PointHead")
        point_logits, points = self.point_pass(feats, stages[-1])
        return out, {"point_logits": point_logits, "points": points}
