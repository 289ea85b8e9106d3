"""Panoptic FPN (``tpudet.models.panoptic_fpn``; Kirillov et al.,
arXiv:1901.02446): Mask R-CNN plus a light semantic FCN over the shared
FPN, through the same two hooks.

The semantic head reads the p2..p5 maps the detector computed already. It
trains with a per-pixel cross-entropy at 1/4 scale against the loader's
``gt_semantic`` (label 0, void and padding, is ignored) and predicts
``semantic [B, H/4, W/4]``, each cell's first maximal class + 1, beside the
instance outputs. Fusing the two into a panoptic segmentation and the PQ
metric are host work (``eval/panoptic.py``).

Labels: 0 void, 1..S stuff (S = data.num_stuff_classes), S+1..S+C things
(C = data.num_classes, the detection classes shifted by S).
"""

from __future__ import annotations

from typing import Dict

import torch

from tpudet_torch.config import Config
from tpudet_torch.models.mask_rcnn import MaskRCNN
from tpudet_torch.train import losses as L


class PanopticFPN(MaskRCNN):
    """``MaskRCNN`` with the semantic branch; ``semantic_loss`` in training,
    ``semantic`` in the detection dict."""

    def __init__(self, cfg: Config, device="cuda"):
        if not cfg.backbone.use_fpn:
            raise ValueError(
                "model='panoptic_fpn' requires backbone.use_fpn=True (the "
                "semantic head consumes the p2..p5 pyramid)")
        if not cfg.data.load_masks or not cfg.data.load_semantic:
            raise ValueError(
                "model='panoptic_fpn' needs data.load_masks=True (instance "
                "branch) AND data.load_semantic=True (semantic branch)")
        super().__init__(cfg, device=device)

    def _extra_losses(self, feats, roi_boxes, tgt_cls, is_fg, roi_valid, mgt,
                      batch) -> Dict[str, torch.Tensor]:
        losses = super()._extra_losses(feats, roi_boxes, tgt_cls, is_fg,
                                       roi_valid, mgt, batch)
        if "gt_semantic" not in batch:
            raise KeyError(
                "panoptic_fpn training needs batch['gt_semantic']: set "
                "data.load_semantic=True so that the loader emits the "
                "1/4-scale class maps")
        logits = self.core.semantic(feats)
        losses["semantic_loss"] = (
            self.cfg.panoptic.loss_weight
            * L.semantic_loss(logits, batch["gt_semantic"]))
        return losses

    def _predict_extras(self, feats, out, batch) -> Dict[str, torch.Tensor]:
        out = super()._predict_extras(feats, out, batch)
        logits = self.core.semantic(feats)
        # Labels 1..S+C (0, void, is never predicted); the first maximum on
        # the CPU and on CUDA alike, as jnp.argmax.
        out["semantic"] = torch.argmax(logits, dim=-1).to(torch.int32) + 1
        return out
