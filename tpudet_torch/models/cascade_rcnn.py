"""Cascade R-CNN (``tpudet.models.cascade_rcnn``; Cai & Vasconcelos,
arXiv:1712.00726): detection heads trained at rising IoU thresholds (0.5,
0.6, 0.7), each on the boxes the one before refined, so that each stage
sees a better proposal distribution than the last.

* Stage 1 samples with the shared balanced sampler (Faster R-CNN's second
  stage) at the cascade's stage-1 delta normalization. Later stages keep
  the same RoIs and relabel them at their threshold against the refined
  boxes (``_cascade_targets_single``: no ignore band, rows that stage 1 did
  not sample stay out). No resampling, as in the paper.
* Boxes are class-agnostic in every stage, with per-stage normalization
  (10/20/30). The box chain is detached: each head trains on the previous
  stage's output boxes, not through them.
* Inference averages the stages' class posteriors, keeps the last stage's
  refined boxes and runs the shared class-offset NMS.

The second and third heads are ``det_head2`` and ``det_head3`` of
``DetectorCore``. Each stage pools its boxes through the same RoI Align
kernel (the FPN one with FPN): three forward launches per predict, three
forward and three backward per train step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from tpudet_torch.config import Config
from tpudet_torch.models.faster_rcnn import FasterRCNN, _gather_rows
from tpudet_torch.ops import boxes as box_ops
from tpudet_torch.ops.matchers import match_boxes
from tpudet_torch.train import losses as L


class CascadeRCNN(FasterRCNN):
    """``FasterRCNN`` with the cascade's stages; the same init, loss and
    predict surface, and per-stage loss terms (``det_cls_loss_s1``, ...)."""

    def __init__(self, cfg: Config, device="cuda"):
        c = cfg.cascade
        t = len(c.stage_iou_thresholds)
        if t < 2:
            raise ValueError(
                "cascade.stage_iou_thresholds needs >= 2 stages "
                f"(got {c.stage_iou_thresholds}); use model='faster_rcnn' "
                "for a single head")
        if len(c.stage_box_reg_weights) != t or len(c.stage_loss_weights) != t:
            raise ValueError(
                f"cascade stage lists disagree: {t} thresholds, "
                f"{len(c.stage_box_reg_weights)} box_reg_weights, "
                f"{len(c.stage_loss_weights)} loss_weights")
        if list(c.stage_iou_thresholds) != sorted(c.stage_iou_thresholds):
            raise ValueError(
                "cascade.stage_iou_thresholds must be non-decreasing "
                f"(got {c.stage_iou_thresholds})")
        if not cfg.roi.class_agnostic_bbox:
            raise ValueError(
                "model='cascade_rcnn' requires roi.class_agnostic_bbox=True: "
                "the box chain feeds each stage ONE refined box per proposal")
        super().__init__(cfg, device=device)

    # ------------------------------------------------------------ training
    def _cascade_targets_single(self, iou_thresh, reg_weights, boxes, valid,
                                gt_boxes, gt_classes, gt_valid):
        """Stage >= 2's labels, per image of the batch: foreground at the
        stage's threshold, background below it (no ignore band), rows that
        stage 1 left invalid stay invalid -> ``(target_classes [B, K],
        target_deltas [B, K, 4], is_fg, valid)``."""
        iou = box_ops.pairwise_iou(boxes, gt_boxes)
        matched, labels = match_boxes(iou, iou_thresh, iou_thresh,
                                      gt_valid=gt_valid,
                                      allow_low_quality=False)
        labels = torch.where(valid, labels, torch.full_like(labels, -1))
        is_fg = labels == 1
        classes = torch.gather(gt_classes, 1, matched.long()).to(torch.int32)
        target_classes = torch.where(is_fg, classes, torch.zeros_like(classes))
        target_deltas = box_ops.encode_boxes(_gather_rows(gt_boxes, matched),
                                             boxes, reg_weights)
        return target_classes, target_deltas, is_fg, labels >= 0

    def _stage_head(self, feats, boxes, stage: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pool the stage's boxes ``[B, K, 4]`` and run its head ->
        ``(cls_logits [B, K, C+1], deltas [B, K, 1, 4])``."""
        b, k = boxes.shape[:2]
        pooled = self._pool_batch(feats, boxes)
        cls_logits, deltas = self.core.roi_head(
            pooled.reshape((b * k,) + pooled.shape[2:]), stage=stage)
        return cls_logits.reshape(b, k, -1), deltas.reshape(b, k, -1, 4)

    def _refine_boxes(self, boxes, deltas, image_hw, reg_weights):
        """One step of the box chain: each RoI's single delta set decoded
        against its box and clipped to its image. Detached: the next stage
        trains on these boxes, not through them."""
        refined = box_ops.decode_boxes(deltas[:, :, 0, :].detach(), boxes,
                                       reg_weights)
        return box_ops.clip_boxes(refined, image_hw[:, None, :])

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``FasterRCNN.loss`` with the cascade's stages: metrics
        ``det_cls_loss_s{t}``, ``det_box_loss_s{t}`` and
        ``num_fg_rois_s{t}`` for t = 1..T, as the JAX package names them.
        The samplers' draws are stage 1's."""
        cfg = self.cfg
        if cfg.rpn_only:
            return super().loss(batch, generator, draws)
        batch, draws = self._loss_inputs(batch, generator, draws)
        images = batch["image"]
        canvas = images.shape[1:3]
        feats = self.core.features(images)
        rpn_logits, rpn_deltas = self.core.rpn(feats)
        metrics: Dict[str, torch.Tensor] = {}
        total = 0.0
        if not cfg.det_only:
            rpn_cls, rpn_box, num_pos = self._rpn_stage_losses(
                self.anchor_boxes(canvas), rpn_logits, rpn_deltas, batch,
                draws["rpn"])
            total = rpn_cls + rpn_box
            metrics.update(rpn_cls_loss=rpn_cls, rpn_box_loss=rpn_box,
                           num_pos_anchors=num_pos)
        prop_boxes, _, prop_valid = self.proposals(
            rpn_logits, rpn_deltas, batch["image_hw"], canvas_hw=canvas,
            training=True)

        c = cfg.cascade
        boxes, tgt_cls, tgt_box, is_fg, roi_valid, _ = self._roi_targets_single(
            prop_boxes, prop_valid, batch["gt_boxes"], batch["gt_classes"],
            batch["gt_valid"], draws["roi"],
            reg_weights=c.stage_box_reg_weights[0])
        stages = len(c.stage_iou_thresholds)
        for t, (thresh, weights, lw) in enumerate(zip(
                c.stage_iou_thresholds, c.stage_box_reg_weights,
                c.stage_loss_weights)):
            if t > 0:  # relabel the same RoIs at this stage's threshold
                tgt_cls, tgt_box, is_fg, roi_valid = (
                    self._cascade_targets_single(
                        thresh, weights, boxes, roi_valid, batch["gt_boxes"],
                        batch["gt_classes"], batch["gt_valid"]))
            cls_logits, deltas = self._stage_head(feats, boxes, t)
            st_cls, st_box = L.detection_losses(cls_logits, deltas, tgt_cls,
                                                tgt_box, is_fg, roi_valid)
            st_cls, st_box = st_cls.mean(), st_box.mean()
            total = total + lw * (st_cls + st_box)
            metrics[f"det_cls_loss_s{t + 1}"] = st_cls
            metrics[f"det_box_loss_s{t + 1}"] = st_box
            metrics[f"num_fg_rois_s{t + 1}"] = (
                (is_fg & roi_valid).sum(dim=1).to(torch.float32).mean())
            if t + 1 < stages:
                boxes = self._refine_boxes(boxes, deltas, batch["image_hw"],
                                           weights)
        metrics["loss"] = total
        return total, metrics

    # ----------------------------------------------------------- inference
    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``FasterRCNN.predict``'s contract: the stages' mean class
        posterior, the last stage's boxes (the same box for every class)
        and the shared class-offset NMS."""
        cfg = self.cfg
        if cfg.rpn_only:
            return super().predict(batch)
        images = batch["image"]
        image_hw = batch["image_hw"].float()
        feats = self.core.features(images)
        rpn_logits, rpn_deltas = self.core.rpn(feats)
        boxes, _, prop_valid = self.proposals(
            rpn_logits, rpn_deltas, image_hw, canvas_hw=images.shape[1:3])
        weights = cfg.cascade.stage_box_reg_weights
        probs_sum = None
        for t in range(len(weights)):
            cls_logits, deltas = self._stage_head(feats, boxes, t)
            probs = torch.softmax(cls_logits, dim=-1)
            probs_sum = probs if probs_sum is None else probs_sum + probs
            # The last step refines the last stage's boxes for the output.
            boxes = self._refine_boxes(boxes, deltas, image_hw, weights[t])
        fg_probs = (probs_sum / len(weights))[:, :, 1:]  # [B, K, C]
        b, k, num_classes = fg_probs.shape
        out_boxes, scores, classes, valid = self._final_nms(
            boxes[:, :, None, :].expand(b, k, num_classes, 4), fg_probs,
            prop_valid)
        return {
            "boxes": out_boxes,
            "scores": scores,
            "classes": classes,
            "valid": valid,
            "num_detections": valid.sum(dim=1, dtype=torch.int32),
        }
