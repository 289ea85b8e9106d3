"""RetinaNet inference and training (``tpudet.models.retinanet``; Lin et al.,
arXiv:1708.02002).

``RetinaNetCore`` owns the layers: the backbone to c5, the P3..P7 pyramid
(``fpn.RetinaNetFPN``) and one head shared over the levels. ``RetinaNet``
runs the pipeline around them: anchors per canvas, targets over every
anchor (no sampling), the focal and box losses, and the postprocess: per
level the top ``pre_nms_topk`` (anchor, class) pairs, decoded, then one
class-aware NMS over the union of the levels, which is one launch of the
NMS kernel per predict (``kernels.class_aware_select``).

The JAX package writes the per-image steps as functions of one image under
``jax.vmap``; here the same functions (same names) take a leading batch
axis. Module names follow the Flax tree (``backbone``, ``fpn``,
``head.cls_conv0``, ``head.cls_logits``, ...).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.config import Config
from tpudet_torch.kernels import class_aware_select
from tpudet_torch.models.faster_rcnn import (
    FasterRCNN,
    _gather_rows,
    _nms_offset,
)
from tpudet_torch.models.fpn import RetinaNetFPN
from tpudet_torch.models.layers import Conv, init_module
from tpudet_torch.models.resnet import build_backbone
from tpudet_torch.ops import boxes as box_ops
from tpudet_torch.ops import selection
from tpudet_torch.ops.matchers import match_boxes
from tpudet_torch.train import losses as L

PYRAMID_STRIDES = (8, 16, 32, 64, 128)


def prior_bias(prior_prob: float) -> float:
    """``-log((1 - pi) / pi)``: every sigmoid starts at ``pi`` (§3.3)."""
    return -math.log((1.0 - prior_prob) / prior_prob)


def flatten_level(x: torch.Tensor, width: int) -> torch.Tensor:
    """NCHW ``[B, A * width, H, W]`` -> f32 ``[B, H * W * A, width]`` in
    (y, x, a) row-major order, the order of the anchor and point grids."""
    b = x.shape[0]
    return x.permute(0, 2, 3, 1).reshape(b, -1, width).float()


def check_pyramid_config(cfg: Config, family: str) -> None:
    """The constructor checks RetinaNet and FCOS share: no two-stage mode,
    the FPN on, and the P3..P7 strides."""
    name = {"retinanet": "a RetinaNet", "fcos": "FCOS"}[family]
    if cfg.rpn_only or cfg.det_only:
        raise ValueError(
            "rpn_only/det_only are two-stage (Faster R-CNN) training "
            f"modes; {name} has neither an RPN nor a second stage")
    if not cfg.backbone.use_fpn:
        raise ValueError(
            f"model='{family}' requires backbone.use_fpn=True "
            "(the detector is defined on a P3-P7 pyramid)")
    if tuple(cfg.anchors.fpn_strides) != PYRAMID_STRIDES:
        raise ValueError(
            f"model='{family}' runs on the fixed P3-P7 pyramid: set "
            "anchors.fpn_strides=(8, 16, 32, 64, 128) "
            f"(got {cfg.anchors.fpn_strides})")


def select_detections(cfg: Config, group, boxes, scores, classes, valid):
    """The one class-aware NMS over the levels' candidates ``[B, K]`` ->
    the detection dict (boxes, scores, classes 1..C and 0 where invalid,
    valid, num_detections)."""
    keep, out_scores, keep_valid = class_aware_select(
        boxes, scores, classes, group.nms_thresh, group.max_detections,
        valid_mask=valid, method=group.nms_method, sigma=group.soft_nms_sigma,
        prune_threshold=group.score_thresh,
        coordinate_offset=_nms_offset(cfg))
    kept_classes = _gather_rows(classes, keep)
    return {
        "boxes": _gather_rows(boxes, keep),
        "scores": out_scores,
        "classes": torch.where(keep_valid, kept_classes,
                               torch.zeros_like(kept_classes)),
        "valid": keep_valid,
        "num_detections": keep_valid.sum(dim=1, dtype=torch.int32),
    }


class RetinaNetHead(nn.Module):
    """Towers shared across levels (§4): ``num_convs`` 3x3 convs + ReLU
    each, then a 3x3 conv to A * C class logits (normal(0.01), bias at the
    prior) and one to A * 4 box deltas (normal(0.01))."""

    def __init__(self, in_ch: int, num_anchors: int, num_classes: int,
                 num_convs: int, channels: int, prior_prob: float,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.num_convs = num_convs
        self.num_classes = num_classes
        self.prior_prob = prior_prob
        for tower in ("cls", "box"):
            ch = in_ch
            for i in range(num_convs):
                self.add_module(f"{tower}_conv{i}", Conv(
                    ch, channels, 3, dtype=dtype, device=device))
                ch = channels
        self.cls_logits = Conv(channels, num_anchors * num_classes, 3,
                               dtype=dtype, device=device, init_std=0.01)
        self.box_deltas = Conv(channels, num_anchors * 4, 3, dtype=dtype,
                               device=device, init_std=0.01)

    def reset_prior(self) -> None:
        with torch.no_grad():
            self.cls_logits.bias.fill_(prior_bias(self.prior_prob))

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW ``[B, C, H, W]`` -> (logits ``[B, H*W*A, classes]`` f32,
        deltas ``[B, H*W*A, 4]`` f32)."""
        cls, box = feat, feat
        for i in range(self.num_convs):
            cls = F.relu(getattr(self, f"cls_conv{i}")(cls))
            box = F.relu(getattr(self, f"box_conv{i}")(box))
        return (flatten_level(self.cls_logits(cls), self.num_classes),
                flatten_level(self.box_deltas(box), 4))


class RetinaNetCore(nn.Module):
    """Backbone + P3..P7 pyramid + shared head."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        bb = cfg.backbone
        dtype = torch.bfloat16 if bb.dtype == "bfloat16" else torch.float32
        self.backbone = build_backbone(bb.name, bb.norm, dtype,
                                       bb.stride_in_1x1, device,
                                       freeze_stem=bb.freeze_stem,
                                       s2d_stem=bb.s2d_stem, remat=bb.remat)
        self.fpn = RetinaNetFPN(self.backbone.channels, dtype=dtype,
                                device=device)
        r = cfg.retinanet
        self.head = RetinaNetHead(
            self.fpn.channels, cfg.anchors.num_fpn_anchors_per_cell,
            cfg.data.num_classes, r.num_convs, r.head_channels, r.prior_prob,
            dtype, device)

    def features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``[B, H, W, 3]`` images -> ``{"p3".."p7"}`` (NCHW,
        channels-last)."""
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return self.fpn(self.backbone(x, stop_at="c5"))

    def heads(self, feats: Dict[str, torch.Tensor]):
        """The shared head over the levels in name order (p3..p7, the
        anchors' order), concatenated."""
        outs = [self.head(feats[name]) for name in sorted(feats)]
        return (torch.cat([o[0] for o in outs], dim=1),
                torch.cat([o[1] for o in outs], dim=1))


class RetinaNet(nn.Module):
    """Pipeline around :class:`RetinaNetCore`, with the surface of
    ``FasterRCNN``. Runs on ``device`` (CUDA unless the caller passes
    ``device="cpu"``)."""

    def __init__(self, cfg: Config, device="cuda"):
        super().__init__()
        check_pyramid_config(cfg, "retinanet")
        self.cfg = cfg
        self.device = torch.device(device)
        self.core = RetinaNetCore(cfg, self.device)
        self._anchors_cache: Dict[Tuple[int, int, str], torch.Tensor] = {}

    def init(self, seed: int = 0) -> "RetinaNet":
        """Draw every weight from ``seed`` with the Flax initializers'
        distributions (the numbers differ from JAX's)."""
        init_module(self.core, torch.Generator().manual_seed(seed))
        self.core.head.reset_prior()
        return self

    # ------------------------------------------------------------- anchors
    # FasterRCNN's FPN anchors over P3..P7, cached per canvas: the levels'
    # grids (ceil(h / stride) cells, each level's sub-octave scales per
    # cell) in level order, and the anchors per level.
    _canvas = FasterRCNN._canvas
    anchor_boxes = FasterRCNN.anchor_boxes
    anchor_level_sizes = FasterRCNN.anchor_level_sizes

    # ---------------------------------------------------------------- loss
    def _targets_single(self, anchors, gt_boxes, gt_classes, gt_valid):
        """Assignment over every anchor of each image (no sampling):
        foreground at IoU >= fg or a ground-truth box's best anchor,
        background below bg, ignored between -> ``(target_classes [B, N],
        target_deltas [B, N, 4], labels [B, N])``."""
        r = self.cfg.retinanet
        iou = box_ops.pairwise_iou(anchors, gt_boxes)  # [B, N, G]
        matched, labels = match_boxes(iou, r.fg_iou_thresh, r.bg_iou_thresh,
                                      gt_valid=gt_valid,
                                      allow_low_quality=True)
        classes = torch.gather(gt_classes, 1, matched.long())
        tgt_classes = torch.where(labels == 1, classes,
                                  torch.zeros_like(classes))
        tgt_deltas = box_ops.encode_boxes(_gather_rows(gt_boxes, matched),
                                          anchors, r.box_reg_weights)
        return tgt_classes, tgt_deltas, labels

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, dp=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training forward on a preprocessed batch (``image``,
        ``image_hw``, ``gt_boxes [B, G, 4]`` xyxy pixels, ``gt_classes``
        1..C, ``gt_valid``) -> ``(total, metrics)``, as
        ``tpudet.models.RetinaNet.loss``. Nothing is drawn (``generator`` is
        not read), and each image's terms are its own means, so the mean
        over a data-parallel group (``dp``, not read) is the joined batch's."""
        del generator, dp
        r = self.cfg.retinanet
        images = batch["image"]
        gt_boxes = batch["gt_boxes"].to(torch.float32)
        anchors = self.anchor_boxes(images.shape[1:3])
        cls_logits, deltas = self.core.heads(self.core.features(images))
        tgt_classes, tgt_deltas, labels = self._targets_single(
            anchors, gt_boxes, batch["gt_classes"], batch["gt_valid"])
        cls_loss, box_loss = L.retinanet_losses(
            cls_logits, deltas, tgt_classes, tgt_deltas, labels,
            alpha=r.focal_alpha, gamma=r.focal_gamma,
            box_weight=r.loss_weight_box, beta=r.smooth_l1_beta)
        cls_loss, box_loss = cls_loss.mean(), box_loss.mean()
        total = cls_loss + box_loss
        return total, {
            "loss": total,
            "focal_cls_loss": cls_loss,
            "box_loss": box_loss,
            "num_pos_anchors": (labels == 1).sum(dim=1).to(torch.float32).mean(),
        }

    # ----------------------------------------------------------- inference
    def _predict_single(self, anchors, level_sizes, cls_logits, deltas,
                        image_hw):
        """Per level, the top ``pre_nms_topk`` (anchor, class) logits
        (sigmoid is monotone), their sigmoid scores and decoded, clipped
        boxes; then the one NMS over the levels' union. The selection is
        the flattened top-k, or with the prefilter ("auto" or "on", on a
        level of more anchors than k) the top-k of each anchor's best class,
        then the top-k of those anchors' class rows."""
        r = self.cfg.retinanet
        num_classes = self.cfg.data.num_classes
        b = cls_logits.shape[0]
        use_prefilter = r.prefilter != "off"
        boxes_l, scores_l, classes_l, valid_l = [], [], [], []
        offset = 0
        for n in level_sizes:
            lvl = cls_logits[:, offset:offset + n]  # [B, n, C]
            k = min(r.pre_nms_topk, n * num_classes)
            if use_prefilter and n > k:
                kp = min(r.pre_nms_topk, n)
                _, surv = selection.blocked_top_k(lvl.max(dim=-1).values, kp)
                flat = _gather_rows(lvl, surv).reshape(b, -1)  # [B, kp*C]
                k = min(r.pre_nms_topk, flat.shape[1])
                top_logits, flat_idx = selection.blocked_top_k(flat, k)
                anchor_idx = offset + torch.gather(
                    surv, 1, torch.div(flat_idx, num_classes,
                                       rounding_mode="floor"))
            else:
                top_logits, flat_idx = selection.blocked_top_k(
                    lvl.reshape(b, -1), k)
                anchor_idx = offset + torch.div(flat_idx, num_classes,
                                                rounding_mode="floor")
            scores = torch.sigmoid(top_logits)
            decoded = box_ops.decode_boxes(_gather_rows(deltas, anchor_idx),
                                           anchors[anchor_idx],
                                           r.box_reg_weights)
            boxes_l.append(box_ops.clip_boxes(decoded, image_hw[:, None, :]))
            scores_l.append(scores)
            classes_l.append((flat_idx % num_classes).to(torch.int32) + 1)
            valid_l.append(scores > r.score_thresh)
            offset += n
        return select_detections(
            self.cfg, r, torch.cat(boxes_l, dim=1), torch.cat(scores_l, dim=1),
            torch.cat(classes_l, dim=1), torch.cat(valid_l, dim=1))

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Inference on a preprocessed batch (``image [B, H, W, 3]``,
        ``image_hw [B, 2]``) -> ``boxes [B, D, 4]``, ``scores [B, D]``,
        ``classes [B, D]`` (1..C), ``valid [B, D]``, ``num_detections
        [B]``, canvas coordinates."""
        images = batch["image"]
        canvas = images.shape[1:3]
        cls_logits, deltas = self.core.heads(self.core.features(images))
        return self._predict_single(
            self.anchor_boxes(canvas), self.anchor_level_sizes(canvas),
            cls_logits, deltas, batch["image_hw"].float())
