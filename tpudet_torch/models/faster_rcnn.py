"""Faster R-CNN inference and training, single-level and FPN
(``tpudet.models.faster_rcnn``).

``DetectorCore`` owns the layers: the backbone (to c4 with the 1x1 neck, or
to c5 with the FPN), the RPN head (shared over p2..p6 with FPN) and the
Fast R-CNN head. ``FasterRCNN`` runs the pipeline around them: anchors,
proposals (top-k, decode, clip, min-size, NMS@0.7; with FPN top-k per level
and level-offset NMS), RoI Align (with FPN each RoI at its level), the head,
per-class decode and the class-offset NMS@0.5.

The JAX package writes the per-image steps as functions of one image under
``jax.vmap``. Here the same functions (same names) take a leading batch
axis, so each NMS and the RoI pooler is one batched kernel launch per
predict. Shapes stay static: proposals ``[B, post_nms_topk]`` and
detections ``[B, max_detections]`` with validity masks; invalid slots carry
what the JAX functions put there (the entry at index 0).

Training (``loss``): RPN targets (match at 0.7/0.3 with the best anchor of
each ground-truth box, cross-boundary anchors ignored, 256 sampled),
training-mode proposals (12,000 -> 2,000) with no gradient, RoI targets
(ground truth appended, match at 0.5, 128 sampled, a quarter foreground),
RoI Align of the sampled RoIs (differentiable in the features: on the card
its backward is a kernel too; with FPN each RoI at its level, the maps'
gradient from the FPN RoI Align's backward kernel) and the two stages'
losses. The samplers' uniform draws come from a ``torch.Generator`` or are
handed in (``draws``), since torch cannot repeat ``jax.random``'s stream.

Two hooks let a family extend the pipeline, as in the JAX package:
``_extra_losses`` adds loss terms from the second stage's samples and
``_predict_extras`` adds outputs from the final detections (Mask R-CNN,
Keypoint R-CNN, Panoptic FPN). Cascade R-CNN (``models/cascade_rcnn.py``)
overrides ``loss`` and ``predict`` and shares the rest.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.config import Config
from tpudet_torch.train import losses as L
from tpudet_torch.kernels import class_aware_select, nms_dispatch
from tpudet_torch.kernels import batched_nms_dispatch
from tpudet_torch.kernels import roi_align as roi_align_kernel
from tpudet_torch.kernels import roi_align_window as roi_align_window_kernel
from tpudet_torch.models.det_head import FastRCNNHead
from tpudet_torch.models.fpn import FPN
from tpudet_torch.models.keypoint_head import KeypointHead
from tpudet_torch.models.layers import Conv, init_module
from tpudet_torch.models.mask_head import MaskHead
from tpudet_torch.models.resnet import build_backbone
from tpudet_torch.models.rpn_head import RPNHead
from tpudet_torch.models.semantic_head import SemanticHead
from tpudet_torch.models.vit import (
    VIT_VARIANTS,
    SimpleFeaturePyramid,
    build_vit,
)
from tpudet_torch.ops import anchors as anchor_ops
from tpudet_torch.ops import boxes as box_ops
from tpudet_torch.ops import selection
from tpudet_torch.ops.matchers import match_boxes
from tpudet_torch.ops.nms import coordinate_offset_for, sort_desc
from tpudet_torch.ops.roi_align import (
    crop_and_resize_batched,
    crop_and_resize_levels,
    fpn_assign_levels,
)
from tpudet_torch.ops.samplers import draw_uniforms, sample_balanced
from tpudet_torch.utils.profiling import span

# Default cap on flattened (box, class) candidates entering the final NMS
# (ROIConfig.max_nms_candidates overrides it).
MAX_NMS_CANDIDATES = 1024
# FPN levels that pool RoIs (p6 only proposes) and their strides.
POOL_LEVELS = ("p2", "p3", "p4", "p5")
POOL_STRIDES = (4.0, 8.0, 16.0, 32.0)
# The JAX package's poolers. "roi_align_gather", "roi_align_pallas" and
# "roi_align_packed" are its other formulations of "roi_align"'s value
# (gathers, a Pallas kernel, one einsum pair over the packed pyramid): here
# they are "roi_align", the same kernel. "crop_and_resize" is another
# function (tf.image.crop_and_resize's convention), in plain PyTorch.
POOLERS = ("roi_align", "roi_align_window", "roi_align_gather",
           "roi_align_pallas", "roi_align_packed", "crop_and_resize")


def _max_canvas_dim(cfg: Config) -> int:
    """Largest canvas side the config can produce."""
    d = cfg.data
    if d.aspect_buckets:
        return max(max(h, w) for h, w in d.aspect_buckets)
    return max(d.canvas_height, d.canvas_width)


def _nms_offset(cfg: Config) -> float:
    """Class-offset stride of the final NMS, from the largest canvas."""
    return coordinate_offset_for(float(_max_canvas_dim(cfg)))


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, k]]`` for ``x`` ``[B, N, ...]`` and ``idx`` ``[B, K]``."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx.long()]


class DetectorCore(nn.Module):
    """Backbone, neck (single-level) or FPN (with a ViT the simple feature
    pyramid), RPN head, Fast R-CNN head and the families' heads: the
    cascade's later stages, the mask head (Mask R-CNN, Panoptic FPN), the
    semantic head (Panoptic FPN) and the keypoint head (Keypoint R-CNN).
    Parameter names follow the Flax tree (``backbone.*``, ``neck_conv``,
    ``fpn.*``, ``rpn_head``, ``det_head``, ``det_head2``, ``mask_head``,
    ``semantic_head``, ``keypoint_head``)."""

    def __init__(self, cfg: Config, device=None):
        super().__init__()
        bb = cfg.backbone
        dtype = torch.bfloat16 if bb.dtype == "bfloat16" else torch.float32
        self.neck_conv = None
        self.fpn = None
        if bb.name in VIT_VARIANTS:
            if not bb.use_fpn:
                raise ValueError(
                    "ViTDet backbones are defined with the simple feature "
                    "pyramid (p2-p6): set backbone.use_fpn=True")
            # ViTDet's pyramid comes from the one stride-16 map, with FPN's
            # p2..p6 contract.
            self.backbone = build_vit(bb.name, bb, dtype, device)
            self.fpn = SimpleFeaturePyramid(self.backbone.dim, dtype=dtype,
                                            device=device)
        else:
            self.backbone = build_backbone(bb.name, bb.norm, dtype,
                                           bb.stride_in_1x1, device,
                                           freeze_stem=bb.freeze_stem,
                                           s2d_stem=bb.s2d_stem,
                                           remat=bb.remat)
            if bb.use_fpn:
                self.fpn = FPN(self.backbone.channels, dtype=dtype,
                               device=device)
        if self.fpn is not None:
            feat_ch = self.fpn.channels
            num_anchors = cfg.anchors.num_fpn_anchors_per_cell
        else:
            feat_ch = self.backbone.channels["c4"]
            num_anchors = cfg.anchors.num_anchors_per_cell
            if bb.neck_channels > 0:
                self.neck_conv = Conv(feat_ch, bb.neck_channels, 1,
                                      dtype=dtype, device=device)
                feat_ch = bb.neck_channels
        self.rpn_head = RPNHead(feat_ch, num_anchors, cfg.rpn.conv_channels,
                                dtype, device)
        s = cfg.roi.output_size
        self.det_head = FastRCNNHead(s * s * feat_ch, cfg.data.num_classes,
                                     cfg.roi.fc_dim,
                                     cfg.roi.class_agnostic_bbox, dtype,
                                     device)
        # Cascade stages 2..T: class-agnostic heads named as Flax names
        # them (det_head2, det_head3).
        if cfg.model == "cascade_rcnn":
            for t in range(2, len(cfg.cascade.stage_iou_thresholds) + 1):
                self.add_module(f"det_head{t}", FastRCNNHead(
                    s * s * feat_ch, cfg.data.num_classes, cfg.roi.fc_dim,
                    True, dtype, device))
        self.mask_head = None
        if cfg.model in ("mask_rcnn", "panoptic_fpn"):
            m = cfg.mask
            self.mask_head = MaskHead(
                feat_ch, 1 if m.class_agnostic else cfg.data.num_classes,
                m.num_convs, m.conv_channels, dtype, device)
        self.semantic_head = None
        if cfg.model == "panoptic_fpn":
            self.semantic_head = SemanticHead(
                feat_ch, cfg.data.num_stuff_classes + cfg.data.num_classes,
                cfg.panoptic.conv_channels, dtype, device)
        self.keypoint_head = None
        if cfg.model == "keypoint_rcnn":
            k = cfg.keypoint
            self.keypoint_head = KeypointHead(
                feat_ch, cfg.data.num_keypoints, k.num_convs,
                k.conv_channels, dtype, device)

    def features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``[B, H, W, 3]`` images -> ``{"c4": [B, C, H/16, W/16]}``, or
        with FPN ``{"p2": .., "p6": ..}``, in channels-last memory format
        (``.permute(0, 2, 3, 1)`` of c4 and p2..p5 is the contiguous NHWC
        map)."""
        x = images.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        if self.fpn is not None:
            return self.fpn(self.backbone(x, stop_at="c5"))
        c4 = self.backbone(x, stop_at="c4")["c4"]
        if self.neck_conv is not None:
            c4 = F.relu(self.neck_conv(c4))
        return {"c4": c4}

    def rpn(self, feats: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The shared head over every level in name order (c4, or p2..p6,
        the order of the anchors), concatenated."""
        outs = [self.rpn_head(feats[name]) for name in sorted(feats)]
        return (torch.cat([o[0] for o in outs], dim=1),
                torch.cat([o[1] for o in outs], dim=1))

    def roi_head(self, pooled: torch.Tensor, stage: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage ``stage``'s head (0: ``det_head``; the cascade's later
        stages ``det_head2``, ...)."""
        if stage == 0:
            return self.det_head(pooled)
        return getattr(self, f"det_head{stage + 1}")(pooled)

    def masks(self, pooled: torch.Tensor) -> torch.Tensor:
        """The mask FCN: ``[N, s, s, C_feat]`` -> ``[N, 2s, 2s, classes]``."""
        return self.mask_head(pooled)

    def keypoints(self, pooled: torch.Tensor) -> torch.Tensor:
        """The keypoint FCN: ``[N, s, s, C_feat]`` -> ``[N, 4s, 4s, K]``."""
        return self.keypoint_head(pooled)

    def semantic(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The semantic FCN: p2..p5 -> ``[B, H/4, W/4, S + C]`` logits."""
        return self.semantic_head(feats)


class FasterRCNN(nn.Module):
    """Pipeline around :class:`DetectorCore`. Runs on ``device`` (CUDA
    unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg: Config, device="cuda"):
        super().__init__()
        if cfg.rpn.topk_method not in ("exact", "blocked", "approx"):
            raise ValueError(f"rpn.topk_method={cfg.rpn.topk_method!r}: "
                             "expected 'exact', 'blocked' or 'approx'")
        if cfg.roi.pooler not in POOLERS:
            raise ValueError(f"roi.pooler={cfg.roi.pooler!r}: expected one "
                             f"of {POOLERS}")
        if cfg.roi.pooler == "roi_align_window" and cfg.backbone.use_fpn:
            max_dim = _max_canvas_dim(cfg)
            # Even a canvas-sized RoI must fit the window at p5 (stride 32),
            # or the fit-bumped level assignment has no level to give it.
            if max_dim / 32.0 > cfg.roi.window - 12:
                raise ValueError(
                    f"roi.window={cfg.roi.window} too small for canvases up "
                    f"to {max_dim}px: need window >= "
                    f"{int(-(-max_dim // 32)) + 12} so p5-level RoIs fit "
                    "(or use pooler='roi_align')")
        self.cfg = cfg
        self.device = torch.device(device)
        self.core = DetectorCore(cfg, self.device)
        self._anchors_cache: Dict[Tuple[int, int, str], torch.Tensor] = {}

    def init(self, seed: int = 0) -> "FasterRCNN":
        """Draw every weight from ``seed`` with the Flax initializers'
        distributions (the numbers differ from JAX's)."""
        generator = torch.Generator().manual_seed(seed)
        init_module(self.core, generator)
        if hasattr(self.core.backbone, "reset_parameters"):
            self.core.backbone.reset_parameters(generator)  # ViT pos_embed
        return self

    # ------------------------------------------------------------- anchors
    def _canvas(self, canvas_hw) -> Tuple[int, int]:
        if canvas_hw is None:
            canvas_hw = (self.cfg.data.canvas_height,
                         self.cfg.data.canvas_width)
        return int(canvas_hw[0]), int(canvas_hw[1])

    def anchor_boxes(self, canvas_hw: Optional[Tuple[int, int]] = None
                     ) -> torch.Tensor:
        """``[N, 4]`` anchors over the canvas; with FPN the levels' grids
        concatenated in level order. SAME-padded stride-2 convs give
        ``ceil(h / stride)`` cells, so the grids use ceil too."""
        h, w = self._canvas(canvas_hw)
        key = (h, w, str(self.device))  # create_train_state may move the model
        if key not in self._anchors_cache:
            a = self.cfg.anchors
            if self.cfg.backbone.use_fpn:
                grid = np.concatenate([
                    anchor_ops.generate_anchors_np(
                        -(-h // s), -(-w // s), s,
                        [sc * o for o in a.fpn_octave_scales],
                        a.aspect_ratios)
                    for s, sc in zip(a.fpn_strides, a.fpn_scales)])
            else:
                grid = anchor_ops.generate_anchors_np(
                    -(-h // a.stride), -(-w // a.stride), a.stride, a.scales,
                    a.aspect_ratios)
            self._anchors_cache[key] = torch.from_numpy(grid).to(self.device)
        return self._anchors_cache[key]

    def anchor_level_sizes(self, canvas_hw: Optional[Tuple[int, int]] = None):
        """Anchors per FPN level, in the order of :meth:`anchor_boxes`."""
        h, w = self._canvas(canvas_hw)
        a = self.cfg.anchors
        per_cell = a.num_fpn_anchors_per_cell
        return [(-(-h // s)) * (-(-w // s)) * per_cell for s in a.fpn_strides]

    # ------------------------------------------------------- proposal path
    def _pre_nms_topk(self, scores, k):
        """Top-k along the last axis with ``lax.top_k``'s tie order, by the
        configured method, all exact. "approx" is the JAX package's
        ``lax.approx_max_k`` at inference (a TPU partial selection at
        ``rpn.topk_recall_target``; on its CPU backend it is ``lax.top_k``):
        here it is the exact top-k on every device, the selection that
        approx approximates at a recall target below 1."""
        if self.cfg.rpn.topk_method == "blocked":
            return selection.blocked_top_k(scores, k,
                                           self.cfg.rpn.topk_block_size)
        return selection.top_k(scores, k)

    def _generate_proposals_single(self, anchors, logits, deltas, image_hw,
                                   training=False):
        """Decode -> clip -> min-size -> top-k -> NMS, for ``[B, N]`` logits
        and ``[B, N, 4]`` deltas -> boxes ``[B, K, 4]``, scores, valid."""
        cfg = self.cfg.rpn
        n = anchors.shape[0]
        k_pre = min(n, cfg.pre_nms_topk_train if training
                    else cfg.pre_nms_topk_test)
        k_post = cfg.post_nms_topk_train if training else cfg.post_nms_topk_test
        # Select on the logits (sigmoid is monotone), then sigmoid the
        # survivors.
        top_logits, idx = self._pre_nms_topk(logits, k_pre)
        top_scores = torch.sigmoid(top_logits)
        if n <= 4 * k_pre:
            decoded = box_ops.decode_boxes(deltas, anchors[None],
                                           cfg.box_reg_weights)
            boxes = _gather_rows(decoded, idx)
        else:
            boxes = box_ops.decode_boxes(_gather_rows(deltas, idx),
                                         anchors[idx], cfg.box_reg_weights)
        boxes = box_ops.clip_boxes(boxes, image_hw[:, None, :])
        wh = boxes[..., 2:] - boxes[..., :2]
        size_ok = (wh[..., 0] > cfg.min_box_size) & (wh[..., 1] > cfg.min_box_size)
        keep_idx, valid = nms_dispatch(
            boxes, top_scores, cfg.nms_thresh, k_post,
            valid_mask=size_ok, presorted=True)  # the sort above is descending
        return (_gather_rows(boxes, keep_idx), _gather_rows(top_scores, keep_idx),
                valid)

    def _generate_proposals_single_fpn(self, anchors, level_sizes, logits,
                                       deltas, image_hw, training=False):
        """FPN protocol: top-k per level on the logits, sigmoid, decode and
        clip the survivors, then NMS within each level (level-offset NMS
        over the union, padded to a multiple of 512) -> boxes ``[B, K, 4]``,
        scores (0 where invalid), valid."""
        cfg = self.cfg.rpn
        k_level = (cfg.fpn_pre_nms_topk_per_level_train if training
                   else cfg.fpn_pre_nms_topk_per_level_test)
        k_post = cfg.post_nms_topk_train if training else cfg.post_nms_topk_test
        b = logits.shape[0]
        dev = logits.device
        cand_boxes, cand_scores, cand_levels = [], [], []
        start = 0
        for li, n_l in enumerate(level_sizes):
            sl = slice(start, start + n_l)
            start += n_l
            top_l, idx = self._pre_nms_topk(logits[:, sl], min(n_l, k_level))
            dec = box_ops.decode_boxes(_gather_rows(deltas[:, sl], idx),
                                       anchors[sl][idx], cfg.box_reg_weights)
            cand_boxes.append(box_ops.clip_boxes(dec, image_hw[:, None, :]))
            cand_scores.append(torch.sigmoid(top_l))
            cand_levels.append(torch.full(top_l.shape, li + 1,
                                          dtype=torch.int32, device=dev))
        boxes = torch.cat(cand_boxes, dim=1)
        top_scores = torch.cat(cand_scores, dim=1)
        levels = torch.cat(cand_levels, dim=1)
        pad = (-boxes.shape[1]) % 512
        if pad:
            boxes = torch.cat([boxes, boxes.new_zeros(b, pad, 4)], dim=1)
            top_scores = torch.cat([top_scores,
                                    top_scores.new_full((b, pad), -1.0)], dim=1)
            levels = torch.cat([levels, levels.new_zeros(b, pad)], dim=1)
        wh = boxes[..., 2:] - boxes[..., :2]
        size_ok = (wh[..., 0] > cfg.min_box_size) & (wh[..., 1] > cfg.min_box_size)
        keep_idx, valid = batched_nms_dispatch(
            boxes, top_scores, levels, cfg.nms_thresh, k_post,
            valid_mask=size_ok, coordinate_offset=_nms_offset(self.cfg))
        kept_scores = _gather_rows(top_scores, keep_idx)
        return (_gather_rows(boxes, keep_idx),
                torch.where(valid, kept_scores, torch.zeros_like(kept_scores)),
                valid)

    def proposals(self, logits, deltas, image_hw, canvas_hw=None,
                  training=False):
        """Batched proposals with the test or (``training``) train counts:
        ``(boxes [B, K, 4], scores [B, K], valid)``. The inputs are
        detached: the second stage takes proposals as data."""
        anchors = self.anchor_boxes(canvas_hw)
        logits, deltas = logits.detach(), deltas.detach()
        if (self.cfg.backbone.use_fpn
                and self.cfg.rpn.fpn_pre_nms_topk_per_level_test > 0):
            return self._generate_proposals_single_fpn(
                anchors, self.anchor_level_sizes(canvas_hw), logits, deltas,
                image_hw, training)
        return self._generate_proposals_single(anchors, logits, deltas,
                                               image_hw, training)

    # ------------------------------------------------------------- pooling
    def _pool_batch(self, feats: Dict[str, torch.Tensor],
                    rois: torch.Tensor,
                    out_size: Optional[int] = None) -> torch.Tensor:
        """RoI Align for all ``B x N`` RoIs in one kernel call: ``rois``
        ``[B, N, 4]`` in image pixels -> ``[B, N, S, S, C]`` with ``S =
        out_size`` (default ``roi.output_size``; the JAX ``_pool_batch`` /
        ``_pool_single``). Single-level: on c4. FPN: each
        RoI at its level of p2..p5, fit-bumped to ``roi.window`` with
        ``pooler="roi_align_window"``; with ``"roi_align"`` (and its other
        formulations, ``POOLERS``) this is the value of the JAX package's
        all-level masked sum. ``"crop_and_resize"`` pools with
        ``ops.roi_align.crop_and_resize`` instead (f32, as the JAX function
        returns it), with FPN at each RoI's FPN-paper level."""
        roi = self.cfg.roi
        size = out_size or roi.output_size
        if self.cfg.backbone.use_fpn:
            fit = roi.window if roi.pooler == "roi_align_window" else 0
            levels = fpn_assign_levels(rois, fit_window=fit) - 2
            maps = [feats[name].permute(0, 2, 3, 1).contiguous()  # NHWC views
                    for name in POOL_LEVELS]
            if roi.pooler == "crop_and_resize":
                return crop_and_resize_levels(maps, POOL_STRIDES, rois,
                                              levels, size)
            return roi_align_window_kernel.roi_align_window(
                maps, POOL_STRIDES, rois.contiguous(), levels.contiguous(),
                size, roi.sampling_ratio)
        b, n = rois.shape[:2]
        fmap = feats["c4"].permute(0, 2, 3, 1).contiguous()  # NHWC, a view
        fboxes = (rois / float(self.cfg.anchors.stride)).reshape(b * n, 4)
        image_index = torch.arange(b, dtype=torch.int32, device=rois.device
                                   ).repeat_interleave(n)
        if roi.pooler == "crop_and_resize":
            pooled = crop_and_resize_batched(fmap, fboxes, image_index, size)
        else:
            pooled = roi_align_kernel.roi_align(
                fmap, fboxes.contiguous(), image_index, size,
                roi.sampling_ratio)
        return pooled.reshape((b, n) + pooled.shape[1:])

    # ------------------------------------------------------------ training
    def draw_shapes(self, b: int, canvas_hw=None) -> Dict[str, Tuple[int, int]]:
        """The ``[B, N]`` shape of each sampler's two uniform draws: the RPN
        samples among the anchors, the RoI stage among the training
        proposals (and the appended ground truth)."""
        n_roi = self.cfg.rpn.post_nms_topk_train
        if self.cfg.roi.append_gt:
            n_roi += self.cfg.data.max_gt_boxes
        return {"rpn": (b, self.anchor_boxes(canvas_hw).shape[0]),
                "roi": (b, n_roi)}

    def draw_samples(self, generator: torch.Generator, b: int,
                     canvas_hw=None) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """``{"rpn": (pos_draws, tie_draws), "roi": (...)}`` from
        ``generator`` (on the model's device), in the shapes of
        :meth:`draw_shapes`."""
        return {stage: draw_uniforms(generator, *shape)
                for stage, shape in self.draw_shapes(b, canvas_hw).items()}

    def _rpn_targets_single(self, anchors, gt_boxes, gt_valid, image_hw,
                            draws):
        """Per image of the batch: match, ignore cross-boundary anchors,
        sample -> ``(idx [B, K], is_pos, valid, target_deltas [B, K, 4])``."""
        cfg = self.cfg.rpn
        iou = box_ops.pairwise_iou(anchors, gt_boxes)  # [B, A, G]
        matched, labels = match_boxes(iou, cfg.fg_iou_thresh,
                                      cfg.bg_iou_thresh, gt_valid=gt_valid,
                                      allow_low_quality=True)
        if cfg.ignore_cross_boundary:
            inside = anchor_ops.anchor_validity_mask_np(
                anchors, image_hw[:, 0:1], image_hw[:, 1:2])
            labels = torch.where(inside, labels, torch.full_like(labels, -1))
        idx, is_pos, valid = sample_balanced(labels, *draws,
                                             cfg.batch_size_per_image,
                                             cfg.positive_fraction)
        mgt = torch.gather(matched, 1, idx.long())
        target_deltas = box_ops.encode_boxes(
            _gather_rows(gt_boxes, mgt), anchors[idx.long()],
            cfg.box_reg_weights)
        return idx, is_pos, valid, target_deltas

    def _roi_targets_single(self, proposals, prop_valid, gt_boxes, gt_classes,
                            gt_valid, draws, reg_weights=None):
        """Per image of the batch: append the ground truth, match at 0.5,
        sample -> ``(boxes [B, K, 4], target_classes, target_deltas,
        is_fg, valid, mgt)`` (``mgt``: each RoI's matched ground truth,
        meaningful where ``is_fg & valid``). ``reg_weights`` overrides the
        delta normalization (the cascade's stage 1); None is
        ``roi.box_reg_weights``."""
        cfg = self.cfg.roi
        if cfg.append_gt:
            proposals = torch.cat([proposals, gt_boxes], dim=1)
            prop_valid = torch.cat([prop_valid, gt_valid], dim=1)
        iou = box_ops.pairwise_iou(proposals, gt_boxes)
        matched, labels = match_boxes(iou, cfg.fg_iou_thresh,
                                      cfg.bg_iou_thresh_hi, gt_valid=gt_valid,
                                      bg_thresh_lo=cfg.bg_iou_thresh_lo)
        labels = torch.where(prop_valid, labels, torch.full_like(labels, -1))
        idx, is_fg, valid = sample_balanced(labels, *draws,
                                            cfg.batch_size_per_image,
                                            cfg.positive_fraction)
        boxes = _gather_rows(proposals, idx)
        mgt = torch.gather(matched, 1, idx.long())
        target_deltas = box_ops.encode_boxes(
            _gather_rows(gt_boxes, mgt), boxes,
            cfg.box_reg_weights if reg_weights is None else reg_weights)
        classes = torch.gather(gt_classes, 1, mgt.long()).to(torch.int32)
        target_classes = torch.where(is_fg & valid, classes,
                                     torch.zeros_like(classes))
        return boxes, target_classes, target_deltas, is_fg, valid, mgt

    def _rpn_stage_losses(self, anchors, rpn_logits, rpn_deltas, batch, draws):
        """RPN targets and losses -> (mean cls loss, mean box loss, mean
        positive count) over the batch."""
        idx, is_pos, valid, tgt_deltas = self._rpn_targets_single(
            anchors, batch["gt_boxes"], batch["gt_valid"], batch["image_hw"],
            draws)
        sampled_logits = torch.gather(rpn_logits, 1, idx.long())
        sampled_deltas = _gather_rows(rpn_deltas, idx)
        rpn_cls, rpn_box = L.rpn_losses(
            sampled_logits, sampled_deltas, tgt_deltas, is_pos, valid,
            box_weight=self.cfg.rpn.loss_weight_box)
        num_pos = (is_pos & valid).sum(dim=1).to(torch.float32).mean()
        return rpn_cls.mean(), rpn_box.mean(), num_pos

    def _loss_inputs(self, batch, generator, draws):
        """The batch with f32 ``image_hw`` and ``gt_boxes``, and the
        samplers' draws: ``draws``, else drawn from ``generator``."""
        if self.cfg.rpn_only and self.cfg.det_only:
            raise ValueError(
                "rpn_only and det_only are mutually exclusive training modes")
        batch = dict(batch, image_hw=batch["image_hw"].to(torch.float32),
                     gt_boxes=batch["gt_boxes"].to(torch.float32))
        if draws is None:
            if generator is None:
                raise ValueError(
                    f"{type(self).__name__}.loss samples anchors and RoIs at "
                    f"random: pass a torch.Generator on {self.device} or the "
                    "draws")
            images = batch["image"]
            draws = self.draw_samples(generator, images.shape[0],
                                      images.shape[1:3])
        return batch, draws

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training forward on a preprocessed batch (``image``,
        ``image_hw``, ``gt_boxes [B, G, 4]`` xyxy pixels, ``gt_classes
        [B, G]`` 1..C, ``gt_valid [B, G]``) -> ``(total, metrics)``, as
        ``tpudet.models.FasterRCNN.loss``, with the same metric names in the
        default, ``rpn_only`` and ``det_only`` modes. The samplers' draws are
        ``draws`` (shapes of :meth:`draw_shapes`) or come from ``generator``
        (on the model's device)."""
        cfg = self.cfg
        batch, draws = self._loss_inputs(batch, generator, draws)
        images = batch["image"]
        b = images.shape[0]
        canvas = images.shape[1:3]
        anchors = self.anchor_boxes(canvas)
        with span("tpudet/backbone"):
            feats = self.core.features(images)
        with span("tpudet/rpn"):
            rpn_logits, rpn_deltas = self.core.rpn(feats)
            if not cfg.det_only:
                rpn_cls, rpn_box, num_pos = self._rpn_stage_losses(
                    anchors, rpn_logits, rpn_deltas, batch, draws["rpn"])
            if cfg.rpn_only:
                total = rpn_cls + rpn_box
                return total, {"loss": total, "rpn_cls_loss": rpn_cls,
                               "rpn_box_loss": rpn_box,
                               "num_pos_anchors": num_pos}
            prop_boxes, _, prop_valid = self.proposals(
                rpn_logits, rpn_deltas, batch["image_hw"], canvas_hw=canvas,
                training=True)
        with span("tpudet/roi_head"):
            roi_boxes, tgt_cls, tgt_box, is_fg, roi_valid, mgt = (
                self._roi_targets_single(
                    prop_boxes, prop_valid, batch["gt_boxes"],
                    batch["gt_classes"], batch["gt_valid"], draws["roi"]))
            pooled = self._pool_batch(feats, roi_boxes)
            r = roi_boxes.shape[1]
            cls_logits, det_deltas = self.core.roi_head(
                pooled.reshape((b * r,) + pooled.shape[2:]))
        det_cls, det_box = L.detection_losses(
            cls_logits.reshape(b, r, -1), det_deltas.reshape(b, r, -1, 4),
            tgt_cls, tgt_box, is_fg, roi_valid)
        det_cls, det_box = det_cls.mean(), det_box.mean()
        num_fg = (is_fg & roi_valid).sum(dim=1).to(torch.float32).mean()
        if cfg.det_only:
            total = det_cls + det_box
            return total, {"loss": total, "det_cls_loss": det_cls,
                           "det_box_loss": det_box, "num_fg_rois": num_fg}
        total = rpn_cls + rpn_box + det_cls + det_box
        metrics = {"rpn_cls_loss": rpn_cls, "rpn_box_loss": rpn_box,
                   "det_cls_loss": det_cls, "det_box_loss": det_box,
                   "num_pos_anchors": num_pos, "num_fg_rois": num_fg}
        for name, value in self._extra_losses(
                feats, roi_boxes, tgt_cls, is_fg, roi_valid, mgt,
                batch).items():
            total = total + value
            metrics[name] = value
        metrics["loss"] = total
        return total, metrics

    # --------------------------------------------------- family extensions
    def _extra_losses(self, feats, roi_boxes, tgt_cls, is_fg, roi_valid, mgt,
                      batch) -> Dict[str, torch.Tensor]:
        """A family's extra loss terms (name -> scalar) from the second
        stage's state: the features, the sampled RoIs ``[B, K, 4]``, their
        target classes, foreground and validity masks, and each RoI's
        matched ground truth ``mgt [B, K]``. Faster R-CNN has none."""
        del feats, roi_boxes, tgt_cls, is_fg, roi_valid, mgt, batch
        return {}

    def _predict_extras(self, feats, out, batch) -> Dict[str, torch.Tensor]:
        """A family's extra outputs added to the detection dict ``out``
        (Mask R-CNN's masks). Faster R-CNN adds none."""
        del feats, batch
        return out

    # ----------------------------------------------------------- inference
    def _postprocess_single(self, proposals, prop_valid, cls_logits,
                            det_deltas, image_hw):
        """Per-class decode -> score threshold -> class-offset NMS -> top
        ``max_detections``, for ``[B, P]`` proposals."""
        probs = torch.softmax(cls_logits, dim=-1)[..., 1:]  # [B, P, C]
        b, p, c = probs.shape
        det_deltas = det_deltas.expand(b, p, c, 4)  # class-agnostic: C_box = 1
        boxes = box_ops.decode_boxes(
            det_deltas, proposals[:, :, None, :].expand(b, p, c, 4),
            self.cfg.roi.box_reg_weights)
        boxes = box_ops.clip_boxes(boxes, image_hw[:, None, None, :])
        return self._final_nms(boxes, probs, prop_valid)

    def _final_nms(self, boxes, probs, prop_valid):
        """Flatten the ``[B, P, C]`` (box, class) candidates -> score
        threshold -> candidate cap -> one class-aware NMS."""
        cfg = self.cfg.roi
        b, p, c = probs.shape
        flat_boxes = boxes.reshape(b, p * c, 4)
        flat_scores = probs.reshape(b, p * c)
        flat_classes = torch.arange(1, c + 1, dtype=torch.int32,
                                    device=probs.device).repeat(p)
        flat_valid = (prop_valid.repeat_interleave(c, dim=1)
                      & (flat_scores > cfg.score_thresh))
        if cfg.max_nms_candidates < 0:
            cap = p * c
        else:
            cap = cfg.max_nms_candidates or MAX_NMS_CANDIDATES
        k_cand = min(p * c, cap)
        cand_scores, cand_idx = sort_desc(
            torch.where(flat_valid, flat_scores, torch.full_like(flat_scores, -1.0)))
        cand_scores, cand_idx = cand_scores[:, :k_cand], cand_idx[:, :k_cand]
        cand_boxes = _gather_rows(flat_boxes, cand_idx)
        cand_classes = flat_classes[cand_idx]
        keep, out_scores, valid = class_aware_select(
            cand_boxes, cand_scores, cand_classes, cfg.nms_thresh,
            cfg.max_detections, valid_mask=cand_scores > 0,
            method=cfg.nms_method, sigma=cfg.soft_nms_sigma,
            prune_threshold=cfg.score_thresh,
            coordinate_offset=_nms_offset(self.cfg))
        classes = _gather_rows(cand_classes, keep)
        return (_gather_rows(cand_boxes, keep), out_scores,
                torch.where(valid, classes, torch.zeros_like(classes)), valid)

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Inference on a preprocessed batch (``image [B, H, W, 3]``,
        ``image_hw [B, 2]`` f32) -> ``boxes [B, D, 4]``, ``scores [B, D]``,
        ``classes [B, D]`` (1..C), ``valid [B, D]``, ``num_detections [B]``."""
        images = batch["image"]
        image_hw = batch["image_hw"].float()
        with span("tpudet/backbone"):
            feats = self.core.features(images)
        with span("tpudet/rpn"):
            rpn_logits, rpn_deltas = self.core.rpn(feats)
            prop_boxes, prop_scores, prop_valid = self.proposals(
                rpn_logits, rpn_deltas, image_hw, canvas_hw=images.shape[1:3])
        if self.cfg.rpn_only:
            # The RPN as a class-agnostic detector.
            d = min(self.cfg.roi.max_detections, prop_boxes.shape[1])
            valid = prop_valid[:, :d]
            return {
                "boxes": prop_boxes[:, :d],
                "scores": torch.where(valid, prop_scores[:, :d],
                                      torch.zeros_like(prop_scores[:, :d])),
                "classes": valid.to(torch.int32),
                "valid": valid,
                "num_detections": valid.sum(dim=1, dtype=torch.int32),
            }
        b, r = prop_boxes.shape[:2]
        with span("tpudet/roi_head"):
            pooled = self._pool_batch(feats, prop_boxes)
            cls_logits, det_deltas = self.core.roi_head(
                pooled.reshape((b * r,) + pooled.shape[2:]))
        with span("tpudet/postprocess"):
            boxes, scores, classes, valid = self._postprocess_single(
                prop_boxes, prop_valid, cls_logits.reshape(b, r, -1),
                det_deltas.reshape(b, r, det_deltas.shape[1], 4), image_hw)
        out = {
            "boxes": boxes,
            "scores": scores,
            "classes": classes,
            "valid": valid,
            "num_detections": valid.sum(dim=1, dtype=torch.int32),
        }
        return self._predict_extras(feats, out, batch)
