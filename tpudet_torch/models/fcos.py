"""FCOS inference and training (``tpudet.models.fcos``; Tian et al.,
arXiv:1904.01355): anchor-free, per location of P3..P7 a class, four
distances (l, t, r, b) and a centerness.

``FCOSCore`` owns the layers: the backbone, the pyramid of RetinaNet
(``fpn.RetinaNetFPN``), one GroupNorm head shared over the levels and a
trainable scale per level. ``FCOS`` runs the pipeline: the point grid per
canvas, the dense [points, ground truth] assignment (centre sampling, the
level's regression range, the smallest box on ties), the focal, GIoU and
centerness losses, and the postprocess: per level the top ``pre_nms_topk``
of ``sigmoid(class) * sigmoid(centerness)``, decoded, then one class-aware
NMS over the levels (one launch of the NMS kernel per predict).

As in ``models/retinanet.py`` the per-image steps take a leading batch axis
and module names follow the Flax tree (``head.cls_conv0``,
``head.cls_gn0``, ``head.centerness``, ``level_scales``, ...).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.config import Config
from tpudet_torch.models.faster_rcnn import _gather_rows
from tpudet_torch.models.fpn import RetinaNetFPN
from tpudet_torch.models.layers import Conv, GroupNorm, init_module
from tpudet_torch.models.resnet import build_backbone
from tpudet_torch.models.retinanet import (
    check_pyramid_config,
    flatten_level,
    prior_bias,
    select_detections,
)
from tpudet_torch.ops import anchors as anchor_ops
from tpudet_torch.ops import boxes as box_ops
from tpudet_torch.ops import selection
from tpudet_torch.train import losses as L


class FCOSHead(nn.Module):
    """Towers shared across levels (§3.1): ``num_convs`` 3x3 convs, each
    followed by Flax's GroupNorm (``min(32, C)`` groups) with ``norm="gn"``,
    and a ReLU; the class tower ends in a 3x3 conv to C logits (prior
    bias), the box tower in one to 4 raw distances and one to the
    centerness logit (normal(0.01) kernels)."""

    def __init__(self, in_ch: int, num_classes: int, num_convs: int,
                 channels: int, prior_prob: float, norm: str,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.num_convs = num_convs
        self.num_classes = num_classes
        self.prior_prob = prior_prob
        self.norm = norm == "gn"
        for tower in ("cls", "box"):
            ch = in_ch
            for i in range(num_convs):
                self.add_module(f"{tower}_conv{i}", Conv(
                    ch, channels, 3, dtype=dtype, device=device))
                if self.norm:
                    self.add_module(f"{tower}_gn{i}",
                                    GroupNorm(channels, device=device))
                ch = channels
        self.cls_logits = Conv(channels, num_classes, 3, dtype=dtype,
                               device=device, init_std=0.01)
        self.box_dists = Conv(channels, 4, 3, dtype=dtype, device=device,
                              init_std=0.01)
        self.centerness = Conv(channels, 1, 3, dtype=dtype, device=device,
                               init_std=0.01)

    def reset_prior(self) -> None:
        with torch.no_grad():
            self.cls_logits.bias.fill_(prior_bias(self.prior_prob))

    def _tower(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        for i in range(self.num_convs):
            x = getattr(self, f"{prefix}_conv{i}")(x)
            if self.norm:
                x = getattr(self, f"{prefix}_gn{i}")(x)
            x = F.relu(x)
        return x

    def forward(self, feat: torch.Tensor):
        """NCHW ``[B, C, H, W]`` -> f32 (logits ``[B, H*W, classes]``, raw
        distances ``[B, H*W, 4]``, centerness logits ``[B, H*W]``)."""
        cls = self._tower(feat, "cls")
        box = self._tower(feat, "box")
        return (flatten_level(self.cls_logits(cls), self.num_classes),
                flatten_level(self.box_dists(box), 4),
                flatten_level(self.centerness(box), 1)[..., 0])


class FCOSCore(nn.Module):
    """Backbone + P3..P7 pyramid + shared head + a trainable scale per
    level."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        bb = cfg.backbone
        dtype = torch.bfloat16 if bb.dtype == "bfloat16" else torch.float32
        self.strides = tuple(cfg.anchors.fpn_strides)
        self.backbone = build_backbone(bb.name, bb.norm, dtype,
                                       bb.stride_in_1x1, device,
                                       freeze_stem=bb.freeze_stem,
                                       s2d_stem=bb.s2d_stem, remat=bb.remat)
        self.fpn = RetinaNetFPN(self.backbone.channels, dtype=dtype,
                                device=device)
        f = cfg.fcos
        self.head = FCOSHead(self.fpn.channels, cfg.data.num_classes,
                             f.num_convs, f.head_channels, f.prior_prob,
                             f.head_norm, dtype, device)
        self.level_scales = nn.Parameter(
            torch.ones(len(self.strides), device=device))

    def features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``[B, H, W, 3]`` images -> ``{"p3".."p7"}``."""
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return self.fpn(self.backbone(x, stop_at="c5"))

    def heads(self, feats: Dict[str, torch.Tensor]):
        """The shared head over the levels in name order, the raw distances
        turned into pixels as ``exp(clip(s_l * raw, -8, 8)) * stride_l``,
        concatenated -> (logits, distances, centerness logits)."""
        logits_all, dists_all, ctr_all = [], [], []
        for i, name in enumerate(sorted(feats)):
            logits, raw, ctr = self.head(feats[name])
            scaled = torch.clamp(self.level_scales[i] * raw, -8.0, 8.0)
            dists_all.append(torch.exp(scaled) * self.strides[i])
            logits_all.append(logits)
            ctr_all.append(ctr)
        return (torch.cat(logits_all, dim=1), torch.cat(dists_all, dim=1),
                torch.cat(ctr_all, dim=1))


def _boxes_from_dists(points: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """(l, t, r, b) distances at (x, y) points -> x1y1x2y2 boxes."""
    x, y = points[..., 0], points[..., 1]
    return torch.stack([x - dists[..., 0], y - dists[..., 1],
                        x + dists[..., 2], y + dists[..., 3]], dim=-1)


class FCOS(nn.Module):
    """Pipeline around :class:`FCOSCore`, with the surface of
    ``FasterRCNN``. Runs on ``device`` (CUDA unless the caller passes
    ``device="cpu"``)."""

    def __init__(self, cfg: Config, device="cuda"):
        super().__init__()
        check_pyramid_config(cfg, "fcos")
        if len(cfg.fcos.regress_range_bounds) != len(cfg.anchors.fpn_strides) - 1:
            raise ValueError(
                f"fcos.regress_range_bounds needs len(fpn_strides)-1 = "
                f"{len(cfg.anchors.fpn_strides) - 1} bounds, got "
                f"{len(cfg.fcos.regress_range_bounds)}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.core = FCOSCore(cfg, self.device)
        self._points_cache: Dict[Tuple[int, int, str], tuple] = {}

    def init(self, seed: int = 0) -> "FCOS":
        """Draw every weight from ``seed`` with the Flax initializers'
        distributions (the numbers differ from JAX's); the level scales
        start at 1."""
        init_module(self.core, torch.Generator().manual_seed(seed))
        self.core.head.reset_prior()
        with torch.no_grad():
            self.core.level_scales.fill_(1.0)
        return self

    # -------------------------------------------------------------- points
    def point_grid(self, canvas_hw=None):
        """Over the canvas: the levels' point grids concatenated ``[N, 2]``,
        each point's stride, the bounds of its level's regression range
        ``(lo, hi]`` (``[N]`` each), and the points per level. SAME-padded
        stride-2 convs give ``ceil(h / stride)`` cells."""
        if canvas_hw is None:
            canvas_hw = (self.cfg.data.canvas_height,
                         self.cfg.data.canvas_width)
        h, w = int(canvas_hw[0]), int(canvas_hw[1])
        key = (h, w, str(self.device))  # create_train_state may move the model
        if key not in self._points_cache:
            strides = self.cfg.anchors.fpn_strides
            bounds = ((0.0,) + tuple(self.cfg.fcos.regress_range_bounds)
                      + (float("inf"),))
            pts, str_c, lo_c, hi_c, sizes = [], [], [], [], []
            for i, s in enumerate(strides):
                p = anchor_ops.generate_points_np(-(-h // s), -(-w // s), s)
                n = p.shape[0]
                pts.append(p)
                sizes.append(n)
                str_c.append(np.full((n,), s, np.float32))
                lo_c.append(np.full((n,), bounds[i], np.float32))
                hi_c.append(np.full((n,), bounds[i + 1], np.float32))
            grids = tuple(torch.from_numpy(np.concatenate(a)).to(self.device)
                          for a in (pts, str_c, lo_c, hi_c))
            self._points_cache[key] = grids + (sizes,)
        return self._points_cache[key]

    # ---------------------------------------------------------------- loss
    def _targets_single(self, points, point_stride, range_lo, range_hi,
                        gt_boxes, gt_classes, gt_valid):
        """The dense assignment (§3.2) of each image: a point is a candidate
        for a box when it lies inside it (and within ``radius * stride`` of
        its centre), its largest distance to the sides falls in the level's
        range and the box is real; the smallest candidate box wins (the
        first on ties) -> ``(target_classes [B, N], target_boxes [B, N,
        4], target_ctr [B, N], pos [B, N])``."""
        f = self.cfg.fcos
        px, py = points[:, 0:1], points[:, 1:2]              # [N, 1]
        x1, y1 = gt_boxes[:, None, :, 0], gt_boxes[:, None, :, 1]  # [B, 1, G]
        x2, y2 = gt_boxes[:, None, :, 2], gt_boxes[:, None, :, 3]
        l, t = px - x1, py - y1                              # [B, N, G]
        r, b = x2 - px, y2 - py
        inside = torch.minimum(torch.minimum(l, r), torch.minimum(t, b)) > 0.0
        max_dist = torch.maximum(torch.maximum(l, r), torch.maximum(t, b))
        in_range = ((max_dist > range_lo[:, None])
                    & (max_dist <= range_hi[:, None]))
        candidate = inside & in_range & gt_valid[:, None, :]
        if f.center_sampling_radius > 0:
            cx = 0.5 * (x1 + x2)
            cy = 0.5 * (y1 + y2)
            rad = f.center_sampling_radius * point_stride[:, None]  # [N, 1]
            near = ((px - cx).abs() <= rad) & ((py - cy).abs() <= rad)
            candidate = candidate & near
        areas = box_ops.area(gt_boxes)[:, None, :]           # [B, 1, G]
        masked = torch.where(candidate, areas,
                             torch.full_like(areas, float("inf")))
        matched = torch.argmin(masked, dim=-1)               # [B, N]
        pos = candidate.any(dim=-1)
        classes = torch.gather(gt_classes, 1, matched)
        tgt_classes = torch.where(pos, classes, torch.zeros_like(classes))
        tgt_boxes = _gather_rows(gt_boxes, matched)          # [B, N, 4]
        # Centerness of the matched box's distances (Eq. 3).
        ml = px[:, 0] - tgt_boxes[..., 0]
        mt = py[:, 0] - tgt_boxes[..., 1]
        mr = tgt_boxes[..., 2] - px[:, 0]
        mb = tgt_boxes[..., 3] - py[:, 0]
        eps = torch.full((), 1e-9, dtype=ml.dtype, device=ml.device)
        ctr = torch.sqrt(torch.clamp(
            (torch.minimum(ml, mr) / torch.maximum(torch.maximum(ml, mr), eps))
            * (torch.minimum(mt, mb)
               / torch.maximum(torch.maximum(mt, mb), eps)), 0.0, 1.0))
        tgt_ctr = torch.where(pos, ctr, torch.zeros_like(ctr))
        return tgt_classes, tgt_boxes, tgt_ctr, pos

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, dp=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training forward on a preprocessed batch -> ``(total,
        metrics)``, as ``tpudet.models.FCOS.loss``. Nothing is drawn and
        each image's terms are its own means (``generator`` and ``dp`` are
        not read, as in ``RetinaNet.loss``)."""
        del generator, dp
        f = self.cfg.fcos
        images = batch["image"]
        gt_boxes = batch["gt_boxes"].to(torch.float32)
        points, stride_c, lo_c, hi_c, _ = self.point_grid(images.shape[1:3])
        cls_logits, dists, ctr_logits = self.core.heads(
            self.core.features(images))
        pred_boxes = _boxes_from_dists(points[None], dists)  # [B, N, 4]
        tgt_classes, tgt_boxes, tgt_ctr, pos = self._targets_single(
            points, stride_c, lo_c, hi_c, gt_boxes, batch["gt_classes"],
            batch["gt_valid"].to(torch.bool))
        cls_loss, box_loss, ctr_loss = (x.mean() for x in L.fcos_losses(
            cls_logits, pred_boxes, ctr_logits, tgt_classes, tgt_boxes,
            tgt_ctr, pos, alpha=f.focal_alpha, gamma=f.focal_gamma,
            box_weight=f.loss_weight_box, ctr_weight=f.loss_weight_ctr))
        total = cls_loss + box_loss + ctr_loss
        return total, {
            "loss": total,
            "focal_cls_loss": cls_loss,
            "giou_box_loss": box_loss,
            "centerness_loss": ctr_loss,
            "num_pos_points": pos.sum(dim=1).to(torch.float32).mean(),
        }

    # ----------------------------------------------------------- inference
    def _predict_single(self, points, level_sizes, cls_logits, dists,
                        ctr_logits, image_hw):
        """Per level, the top ``pre_nms_topk`` (location, class) scores
        ``sigmoid(class) * sigmoid(centerness)`` and their decoded, clipped
        boxes; then the one NMS over the levels' union."""
        f = self.cfg.fcos
        num_classes = self.cfg.data.num_classes
        b = cls_logits.shape[0]
        boxes_l, scores_l, classes_l, valid_l = [], [], [], []
        offset = 0
        for n in level_sizes:
            sl = slice(offset, offset + n)
            lvl_scores = (torch.sigmoid(cls_logits[:, sl])
                          * torch.sigmoid(ctr_logits[:, sl])[..., None]
                          ).reshape(b, -1)  # [B, n*C]
            k = min(f.pre_nms_topk, lvl_scores.shape[1])
            top_scores, flat_idx = selection.blocked_top_k(lvl_scores, k)
            point_idx = offset + torch.div(flat_idx, num_classes,
                                           rounding_mode="floor")
            decoded = _boxes_from_dists(points[point_idx],
                                        _gather_rows(dists, point_idx))
            boxes_l.append(box_ops.clip_boxes(decoded, image_hw[:, None, :]))
            scores_l.append(top_scores)
            classes_l.append((flat_idx % num_classes).to(torch.int32) + 1)
            valid_l.append(top_scores > f.score_thresh)
            offset += n
        return select_detections(
            self.cfg, f, torch.cat(boxes_l, dim=1), torch.cat(scores_l, dim=1),
            torch.cat(classes_l, dim=1), torch.cat(valid_l, dim=1))

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Inference on a preprocessed batch -> the detection dict of
        ``RetinaNet.predict``."""
        images = batch["image"]
        points, _, _, _, level_sizes = self.point_grid(images.shape[1:3])
        cls_logits, dists, ctr_logits = self.core.heads(
            self.core.features(images))
        return self._predict_single(points, level_sizes, cls_logits, dists,
                                    ctr_logits, batch["image_hw"].float())
