"""Keypoint R-CNN (``tpudet.models.keypoint_rcnn``; He et al.,
arXiv:1703.06870 §5): Faster R-CNN plus a per-RoI keypoint-heatmap FCN,
through the two hooks of ``FasterRCNN``, as Mask R-CNN.

* ``_extra_losses`` (training). The balanced sampler puts its positives
  first, so the first ``round(batch_size_per_image * positive_fraction)``
  sampled RoIs of an image hold every foreground sample (128 at the
  preset's 512 x 0.25). The branch pools that prefix at
  ``keypoint.roi_output_size`` (14) through the RoI Align kernels, runs the
  FCN and takes a softmax cross-entropy over the S^2 heatmap cells (S =
  4 x 14 = 56) for each labeled keypoint inside its RoI. The targets are
  grid indices from the RoI and its matched ground truth's keypoints, by
  arithmetic alone (``_keypoint_targets_single``; data, so no gradient).
* ``_predict_extras`` (inference). It pools the final detections, runs the
  FCN once and takes each keypoint's first maximal cell: ``keypoints [B,
  D, K, 3]`` = (x, y, softmax score) in canvas pixels (the frame of
  ``boxes``), zero on invalid rows.
"""

from __future__ import annotations

from typing import Dict

import torch

from tpudet_torch.config import Config
from tpudet_torch.models.faster_rcnn import FasterRCNN, _gather_rows
from tpudet_torch.train import losses as L


class KeypointRCNN(FasterRCNN):
    """``FasterRCNN`` with the keypoint branch; the same init, loss and
    predict surface, and ``keypoints`` in the detection dict."""

    def __init__(self, cfg: Config, device="cuda"):
        if cfg.rpn_only or cfg.det_only:
            raise ValueError(
                "keypoint_rcnn does not support the rpn_only/det_only "
                "alternating-training modes (train the faster_rcnn family in "
                "those modes and carry the weights over)")
        k = cfg.data.num_keypoints
        for a, b in cfg.data.keypoint_flip_pairs:
            if not (0 <= a < k and 0 <= b < k):
                raise ValueError(
                    f"keypoint_flip_pairs entry {(a, b)} out of range for "
                    f"num_keypoints={k}")
        super().__init__(cfg, device=device)

    @property
    def _heatmap_size(self) -> int:
        """Heatmap side S: pooled s -> deconv 2s -> bilinear 4s."""
        return 4 * self.cfg.keypoint.roi_output_size

    @property
    def _num_kp_rois(self) -> int:
        """The branch's RoIs per image: the sampler's positives-first
        prefix."""
        roi = self.cfg.roi
        return int(round(roi.batch_size_per_image * roi.positive_fraction))

    def _keypoint_targets_single(self, rois, gt_keypoints, matched_gt):
        """Per image of the batch: each matched ground-truth keypoint's cell
        of the RoI's S x S heatmap, valid where it is labeled (v > 0) and
        strictly inside the RoI. ``rois [B, R, 4]``, ``gt_keypoints [B, G,
        K, 3]``, ``matched_gt [B, R]`` -> (flat cell index ``[B, R, K]``
        int32, valid ``[B, R, K]``). The operations and their order are the
        JAX package's, so no index moves at a cell edge."""
        s = self._heatmap_size
        kp = _gather_rows(gt_keypoints, matched_gt)          # [B, R, K, 3]
        x1, y1 = rois[..., 0:1], rois[..., 1:2]
        w = (rois[..., 2:3] - x1).clamp(min=1e-6)
        h = (rois[..., 3:4] - y1).clamp(min=1e-6)
        u = (kp[..., 0] - x1) / w * s
        v = (kp[..., 1] - y1) / h * s
        inside = (u >= 0) & (u < s) & (v >= 0) & (v < s)
        valid = inside & (kp[..., 2] > 0)
        gx = torch.floor(u).clamp(0, s - 1).to(torch.int32)
        gy = torch.floor(v).clamp(0, s - 1).to(torch.int32)
        return gy * s + gx, valid

    def _extra_losses(self, feats, roi_boxes, tgt_cls, is_fg, roi_valid, mgt,
                      batch) -> Dict[str, torch.Tensor]:
        if "gt_keypoints" not in batch:
            raise KeyError(
                "keypoint_rcnn training needs batch['gt_keypoints']: set "
                "data.load_keypoints=True so that the loader emits them")
        k = self.cfg.keypoint
        kf = self._num_kp_rois
        rois = roi_boxes[:, :kf]
        with torch.no_grad():
            tgt_idx, tgt_valid = self._keypoint_targets_single(
                rois, batch["gt_keypoints"].to(torch.float32), mgt[:, :kf])
        pooled = self._pool_batch(feats, rois, out_size=k.roi_output_size)
        b = rois.shape[0]
        logits = self.core.keypoints(
            pooled.reshape((b * kf,) + pooled.shape[2:]))
        s = self._heatmap_size
        per_image = L.keypoint_loss(logits.reshape(b, kf, s, s, -1), tgt_idx,
                                    tgt_valid, (is_fg & roi_valid)[:, :kf])
        return {"keypoint_loss": k.loss_weight * per_image.mean()}

    def _predict_extras(self, feats, out, batch) -> Dict[str, torch.Tensor]:
        boxes = out["boxes"]
        b, d = boxes.shape[:2]
        pooled = self._pool_batch(feats, boxes,
                                  out_size=self.cfg.keypoint.roi_output_size)
        logits = self.core.keypoints(
            pooled.reshape((b * d,) + pooled.shape[2:]))  # [B*D, S, S, K]
        s = self._heatmap_size
        nk = logits.shape[-1]
        flat = logits.reshape(b * d, s * s, nk)
        probs = torch.softmax(flat, dim=1)
        # torch.argmax takes the first maximum on the CPU and on CUDA alike,
        # as jnp.argmax does.
        idx = torch.argmax(flat, dim=1)                   # [B*D, K]
        score = torch.gather(probs, 1, idx[:, None, :])[:, 0, :]
        gx = (idx % s).to(torch.float32) + 0.5
        gy = torch.div(idx, s, rounding_mode="floor").to(torch.float32) + 0.5
        fb = boxes.reshape(b * d, 4)
        x1, y1 = fb[:, 0:1], fb[:, 1:2]
        w = (fb[:, 2:3] - x1).clamp(min=1e-6)
        h = (fb[:, 3:4] - y1).clamp(min=1e-6)
        kx = x1 + gx / s * w
        ky = y1 + gy / s * h
        kps = torch.stack([kx, ky, score], dim=-1).reshape(b, d, nk, 3)
        out["keypoints"] = kps * out["valid"][:, :, None, None]
        return out
