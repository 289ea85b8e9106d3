"""Mask R-CNN (``tpudet.models.mask_rcnn``; He et al., arXiv:1703.06870):
Faster R-CNN plus a per-RoI mask FCN, through the two hooks of
``FasterRCNN``.

* ``_extra_losses`` (training). The balanced RoI sampler puts its
  positives first, so the first ``round(batch_size_per_image *
  positive_fraction)`` sampled RoIs of an image hold every foreground
  sample: a static prefix (32 at the FPN preset's 128 x 0.25). The branch
  pools that prefix at ``mask.roi_output_size`` (14; the box head pools 7)
  through the same RoI Align kernels, whose backward scatters the mask
  loss's gradient into the features, runs the FCN and takes the BCE
  against targets resampled from the loader's box-frame crops
  (``ops.masks``; data, so no gradient).
* ``_predict_extras`` (inference). It pools the final detections (the
  paper's "masks from the refined boxes"), runs the FCN once, takes each
  detection's class channel and its sigmoid: ``masks [B, D, 2s, 2s]``,
  probabilities in each box's own frame, zero on invalid rows. Pasting to
  image pixels stays on the host (``data.masks.paste_mask``).
"""

from __future__ import annotations

from typing import Dict

import torch

from tpudet_torch.config import Config
from tpudet_torch.models.faster_rcnn import FasterRCNN
from tpudet_torch.ops.masks import mask_targets
from tpudet_torch.train import losses as L


class MaskRCNN(FasterRCNN):
    """``FasterRCNN`` with the mask branch; the same init, loss and predict
    surface, and ``masks`` in the detection dict."""

    def __init__(self, cfg: Config, device="cuda"):
        if cfg.rpn_only or cfg.det_only:
            raise ValueError(
                "mask_rcnn does not support the rpn_only/det_only "
                "alternating-training modes (train the faster_rcnn family in "
                "those modes and carry the weights over)")
        super().__init__(cfg, device=device)

    @property
    def _num_mask_rois(self) -> int:
        """The mask branch's RoIs per image: the sampler's positives-first
        prefix."""
        roi = self.cfg.roi
        return int(round(roi.batch_size_per_image * roi.positive_fraction))

    def _extra_losses(self, feats, roi_boxes, tgt_cls, is_fg, roi_valid, mgt,
                      batch) -> Dict[str, torch.Tensor]:
        if "gt_masks" not in batch:
            raise KeyError(
                "mask_rcnn training needs batch['gt_masks']: set "
                "data.load_masks=True so that the loader emits box-frame "
                "ground-truth mask crops")
        m = self.cfg.mask
        kf = self._num_mask_rois
        rois = roi_boxes[:, :kf]
        s_out = 2 * m.roi_output_size  # the deconv doubles the pooled size
        with torch.no_grad():
            targets = mask_targets(batch["gt_masks"], batch["gt_boxes"], rois,
                                   mgt[:, :kf], s_out)
        pooled = self._pool_batch(feats, rois, out_size=m.roi_output_size)
        b = rois.shape[0]
        logits = self.core.masks(pooled.reshape((b * kf,) + pooled.shape[2:]))
        per_image = L.mask_loss(logits.reshape(b, kf, s_out, s_out, -1),
                                targets, tgt_cls[:, :kf],
                                (is_fg & roi_valid)[:, :kf])
        return {"mask_loss": m.loss_weight * per_image.mean()}

    def _predict_extras(self, feats, out, batch) -> Dict[str, torch.Tensor]:
        boxes = out["boxes"]
        b, d = boxes.shape[:2]
        pooled = self._pool_batch(feats, boxes,
                                  out_size=self.cfg.mask.roi_output_size)
        logits = self.core.masks(pooled.reshape((b * d,) + pooled.shape[2:]))
        probs = torch.sigmoid(
            L.mask_class_channel(logits, out["classes"].reshape(-1)))
        out["masks"] = (probs.reshape(b, d, *probs.shape[1:])
                        * out["valid"][:, :, None, None])
        return out
