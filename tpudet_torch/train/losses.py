"""Detection losses (``tpudet.train.losses``): Faster R-CNN's RPN and
detection-head losses, Mask R-CNN's mask loss, Keypoint R-CNN's keypoint
loss, Panoptic FPN's semantic loss, RetinaNet's and FCOS's losses, and the
DETR and Deformable DETR set losses.

Each is JAX's per-image function with any leading axes (a batch of images
where JAX ``vmap``s): the reductions run over the last sample axis and the
results keep the leading ones. The set losses are called once over every
(decoder layer, image) problem, so the matcher solves them all in one
lockstep batch.

RPN (Faster R-CNN §3.1.2): binary cross-entropy over the sampled anchors
and smooth-L1 (beta 1/9) over the positives' deltas, both divided by the
number of sampled anchors. Detection head (Fast R-CNN §2.3): softmax
cross-entropy over C + 1 classes and smooth-L1 (beta 1) over the
foreground rows' matched-class deltas, both divided by the number of
sampled RoIs. Mask R-CNN (arXiv:1703.06870 §3): a per-pixel sigmoid BCE on
the matched class's mask, the mean over pixels, then over the foreground
RoIs. Keypoint R-CNN (§5): a softmax cross-entropy over the heatmap's cells
for each labeled keypoint of a foreground RoI, their mean. Panoptic FPN
(arXiv:1901.02446 §3): a per-pixel softmax cross-entropy, its mean over
the non-void pixels of the whole batch (the JAX package calls it once
over the batch). RetinaNet (arXiv:1708.02002 Eq. 4-5) and FCOS
(arXiv:1904.01355 §3): a sigmoid focal loss over every anchor or location,
divided by the positive count. Every loss is 0, not NaN, where nothing is
sampled.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpudet_torch.ops.boxes import (
    cxcywh_to_xyxy,
    elementwise_giou,
    pairwise_giou,
)
from tpudet_torch.ops.hungarian import hungarian_masked


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber): ``0.5 x^2 / beta`` for ``|x| < beta``,
    else ``|x| - 0.5 beta``; ``|x|`` for ``beta <= 0``."""
    diff = (pred - target).abs()
    if beta <= 0.0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def _safe_mean(values: torch.Tensor, mask: torch.Tensor,
               denom: torch.Tensor = None) -> torch.Tensor:
    """Sum over the last axis of ``values * mask`` over ``denom`` (default:
    the mask's count); 0 where ``denom`` is 0."""
    total = (values * mask).sum(dim=-1)
    if denom is None:
        denom = mask.sum(dim=-1)
    return torch.where(denom > 0, total / denom.clamp(min=1.0),
                       torch.zeros_like(total))


def mask_class_channel(mask_logits: torch.Tensor,
                       classes: torch.Tensor) -> torch.Tensor:
    """``[..., m, m, C]`` per-class mask logits -> ``[..., m, m]``: each
    row's channel of its class ``classes [...]`` (1..C), the single channel
    of a class-agnostic head."""
    c = mask_logits.shape[-1]
    if c == 1:
        return mask_logits[..., 0]
    slot = (classes.long() - 1).clamp(0, c - 1)
    index = slot[..., None, None, None].expand(*mask_logits.shape[:-1], 1)
    return torch.gather(mask_logits, -1, index)[..., 0]


def mask_loss(
    mask_logits: torch.Tensor,     # [..., R, m, m, C] per-class logits
    targets: torch.Tensor,         # [..., R, m, m] binary targets
    target_classes: torch.Tensor,  # [..., R] matched class, 1..C
    fg_valid: torch.Tensor,        # [..., R] bool: foreground and valid
) -> torch.Tensor:
    """Mask R-CNN's mask loss per image ``[...]``: BCE on the matched
    class's channel (the single channel of a class-agnostic head), the mean
    over the pixels of each RoI, then over the foreground RoIs; 0 for an
    image with none."""
    logits = mask_class_channel(mask_logits, target_classes)
    bce = (logits.clamp(min=0.0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    per_roi = bce.mean(dim=(-2, -1))
    return _safe_mean(per_roi, fg_valid.to(torch.float32))


def keypoint_loss(
    logits: torch.Tensor,        # [..., R, S, S, K] heatmap logits
    target_idx: torch.Tensor,    # [..., R, K] flat cell index
    target_valid: torch.Tensor,  # [..., R, K] bool: labeled, inside the RoI
    fg_valid: torch.Tensor,      # [..., R] bool: foreground and valid
) -> torch.Tensor:
    """Keypoint R-CNN's loss per image ``[...]``: each valid keypoint of a
    foreground RoI is one class of the S^2 cells; the mean of their softmax
    cross-entropies, 0 for an image with none."""
    *lead, r, s1, s2, k = logits.shape
    flat = logits.float().reshape(*lead, r, s1 * s2, k).transpose(-1, -2)
    logp = torch.log_softmax(flat, dim=-1)                 # [..., R, K, S^2]
    ce = -torch.gather(logp, -1, target_idx.long()[..., None])[..., 0]
    use = (target_valid & fg_valid[..., None]).to(torch.float32)
    return _safe_mean(ce.flatten(-2), use.flatten(-2))


def semantic_loss(
    logits: torch.Tensor,   # [B, H, W, C] semantic logits
    targets: torch.Tensor,  # [B, H, W] labels, 0 void (ignored)
) -> torch.Tensor:
    """Panoptic FPN's semantic loss, a scalar: the per-pixel softmax
    cross-entropy of label l > 0 at channel l - 1, its mean over the
    non-void pixels of the batch; 0 when every pixel is void."""
    c = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    slot = (targets.long() - 1).clamp(0, c - 1)
    ce = -torch.gather(logp, -1, slot[..., None])[..., 0]
    valid = (targets > 0).to(torch.float32)
    return _safe_mean(ce.reshape(-1), valid.reshape(-1))


def _one_hot(target_classes: torch.Tensor, num_classes: int,
             positive: torch.Tensor) -> torch.Tensor:
    """``[..., N]`` classes 1..C -> ``[..., N, C]`` f32 one-hot rows where
    ``positive``, zero rows elsewhere (``jax.nn.one_hot(c - 1) * pos``)."""
    classes = torch.arange(num_classes, device=target_classes.device)
    return (((target_classes.long() - 1)[..., None] == classes)
            & positive[..., None]).to(torch.float32)


def _focal(logits: torch.Tensor, onehot: torch.Tensor, alpha: float,
           gamma: float) -> torch.Tensor:
    """Elementwise sigmoid focal loss: BCE with logits times ``alpha_t (1 -
    p_t)^gamma``, in JAX's formula and order."""
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    bce = (torch.maximum(logits, zero) - logits * onehot
           + torch.log1p(torch.exp(-logits.abs())))
    p = torch.sigmoid(logits)
    p_t = p * onehot + (1.0 - p) * (1.0 - onehot)
    alpha_t = alpha * onehot + (1.0 - alpha) * (1.0 - onehot)
    return alpha_t * torch.pow(1.0 - p_t, gamma) * bce


def retinanet_losses(
    cls_logits: torch.Tensor,      # [..., N, C] per-anchor class logits
    deltas: torch.Tensor,          # [..., N, 4] predicted deltas
    target_classes: torch.Tensor,  # [..., N] 0 background, 1..C foreground
    target_deltas: torch.Tensor,   # [..., N, 4] encoded ground truth
    labels: torch.Tensor,          # [..., N] 1 fg, 0 bg, -1 ignored
    alpha: float = 0.25,
    gamma: float = 2.0,
    box_weight: float = 1.0,
    beta: float = 0.11,
):
    """-> ``(cls_loss [...], box_weight * box_loss [...])``: the focal loss
    over every anchor that is not ignored and smooth-L1 over the positives'
    deltas, both divided by the positive count clamped to 1."""
    num_classes = cls_logits.shape[-1]
    use = (labels >= 0).to(torch.float32)
    pos = labels == 1
    pos_f = pos.to(torch.float32)
    num_pos = pos_f.sum(dim=-1).clamp(min=1.0)
    onehot = _one_hot(target_classes, num_classes, pos)
    focal = _focal(cls_logits, onehot, alpha, gamma)
    cls_loss = (focal * use[..., None]).sum(dim=(-2, -1)) / num_pos
    box_per = smooth_l1(deltas, target_deltas, beta).sum(dim=-1)
    box_loss = (box_per * pos_f).sum(dim=-1) / num_pos
    return cls_loss, box_weight * box_loss


def fcos_losses(
    cls_logits: torch.Tensor,      # [..., N, C] per-location class logits
    pred_boxes: torch.Tensor,      # [..., N, 4] decoded predicted boxes
    ctr_logits: torch.Tensor,      # [..., N] centerness logits
    target_classes: torch.Tensor,  # [..., N] 0 background, 1..C
    target_boxes: torch.Tensor,    # [..., N, 4] matched ground truth
    target_ctr: torch.Tensor,      # [..., N] centerness targets
    pos: torch.Tensor,             # [..., N] bool
    alpha: float = 0.25,
    gamma: float = 2.0,
    box_weight: float = 1.0,
    ctr_weight: float = 1.0,
):
    """-> ``(cls_loss, box_weight * box_loss, ctr_weight * ctr_loss)``, each
    ``[...]``: the focal loss over every location divided by the positive
    count (clamped to 1); 1 - GIoU over the positives weighted by their
    centerness targets and divided by the targets' sum (0 without a
    positive); the centerness BCE's mean over the positives."""
    num_classes = cls_logits.shape[-1]
    pos_f = pos.to(torch.float32)
    num_pos = pos_f.sum(dim=-1).clamp(min=1.0)
    onehot = _one_hot(target_classes, num_classes, pos)
    cls_loss = _focal(cls_logits, onehot, alpha, gamma).sum(dim=(-2, -1)) / num_pos
    giou = elementwise_giou(pred_boxes, target_boxes)
    ctr_w = target_ctr * pos_f
    box_loss = ((1.0 - giou) * ctr_w).sum(dim=-1) / ctr_w.sum(dim=-1).clamp(
        min=1e-6)
    box_loss = torch.where(pos_f.sum(dim=-1) > 0, box_loss,
                           torch.zeros_like(box_loss))
    zero = torch.zeros((), dtype=ctr_logits.dtype, device=ctr_logits.device)
    ctr_bce = (torch.maximum(ctr_logits, zero) - ctr_logits * target_ctr
               + torch.log1p(torch.exp(-ctr_logits.abs())))
    ctr_loss = _safe_mean(ctr_bce, pos_f, denom=num_pos)
    return cls_loss, box_weight * box_loss, ctr_weight * ctr_loss


def rpn_losses(
    logits: torch.Tensor,         # [..., K] objectness of the sampled anchors
    deltas: torch.Tensor,         # [..., K, 4] their predicted deltas
    target_deltas: torch.Tensor,  # [..., K, 4] encoded ground truth
    is_positive: torch.Tensor,    # [..., K] bool
    valid: torch.Tensor,          # [..., K] bool: real samples
    box_weight: float = 1.0,
    beta: float = 1.0 / 9.0,
):
    """-> ``(cls_loss [...], box_weight * box_loss [...])``."""
    valid_f = valid.to(torch.float32)
    pos_f = (is_positive & valid).to(torch.float32)
    num_samples = valid_f.sum(dim=-1)
    # Stable BCE with logits; ``maximum`` against zero splits the gradient
    # of a zero logit as ``jnp.maximum`` does.
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    cls_per = (torch.maximum(logits, zero) - logits * pos_f
               + torch.log1p(torch.exp(-logits.abs())))
    cls_loss = _safe_mean(cls_per, valid_f, denom=num_samples)
    box_per = smooth_l1(deltas, target_deltas, beta).sum(dim=-1)
    box_loss = _safe_mean(box_per, pos_f, denom=num_samples)
    return cls_loss, box_weight * box_loss


def detection_losses(
    cls_logits: torch.Tensor,      # [..., R, C+1]
    deltas: torch.Tensor,          # [..., R, C_box, 4] (C_box = C or 1)
    target_classes: torch.Tensor,  # [..., R] int, 0 = background
    target_deltas: torch.Tensor,   # [..., R, 4]
    is_foreground: torch.Tensor,   # [..., R] bool
    valid: torch.Tensor,           # [..., R] bool
    beta: float = 1.0,
):
    """-> ``(cls_loss [...], box_loss [...])``. Each row's box loss reads its
    target class's delta slot (class c -> slot c - 1; a class-agnostic head
    has the one slot 0)."""
    valid_f = valid.to(torch.float32)
    fg_f = (is_foreground & valid).to(torch.float32)
    num_samples = valid_f.sum(dim=-1)
    target = target_classes.long()
    logp = F.log_softmax(cls_logits, dim=-1)
    cls_per = -torch.gather(logp, -1, target[..., None])[..., 0]
    cls_loss = _safe_mean(cls_per, valid_f, denom=num_samples)
    if deltas.shape[-2] == 1:
        sel = deltas[..., 0, :]
    else:
        slot = (target - 1).clamp(0, deltas.shape[-2] - 1)
        sel = torch.gather(
            deltas, -2, slot[..., None, None].expand(*slot.shape, 1, 4)
        )[..., 0, :]
    box_per = smooth_l1(sel, target_deltas, beta).sum(dim=-1)
    box_loss = _safe_mean(box_per, fg_f, denom=num_samples)
    return cls_loss, box_loss


def _matched_box_terms(pred_boxes, gt_boxes, gt_valid, match):
    """The set losses' box terms over the matched valid pairs -> ``(l1_sum,
    giou_sum, num_pos)``, each ``[...]``. The matcher's sentinel ``Q`` of an
    invalid row is clamped to ``Q - 1`` in the gather (JAX's gathers clamp),
    whose row the validity mask then zeroes."""
    index = match.clamp(max=pred_boxes.shape[-2] - 1)
    matched = torch.gather(pred_boxes, -2,
                           index[..., None].expand(*index.shape, 4))
    valid_f = gt_valid.to(torch.float32)
    l1 = (matched - gt_boxes).abs().sum(dim=-1)
    giou = elementwise_giou(cxcywh_to_xyxy(matched), cxcywh_to_xyxy(gt_boxes))
    return ((l1 * valid_f).sum(dim=-1), ((1.0 - giou) * valid_f).sum(dim=-1),
            valid_f.sum(dim=-1))


def _target_classes(match, gt_classes, num_queries):
    """``[..., Q]`` each query's matched class, 0 for unmatched queries:
    JAX's ``zeros(Q).at[match].set(gt_classes, mode="drop")``, the
    sentinel ``Q`` landing in an extra column that is then dropped."""
    tgt = torch.zeros((*match.shape[:-1], num_queries + 1), dtype=torch.long,
                      device=match.device)
    return tgt.scatter(-1, match, gt_classes.long())[..., :num_queries]


def detr_set_loss(
    logits: torch.Tensor,      # [..., Q, C+1] class logits, 0 = no object
    pred_boxes: torch.Tensor,  # [..., Q, 4] normalized (cx, cy, w, h)
    gt_boxes: torch.Tensor,    # [..., G, 4] normalized (cx, cy, w, h), padded
    gt_classes: torch.Tensor,  # [..., G] int 1..C (padding rows arbitrary)
    gt_valid: torch.Tensor,    # [..., G] bool
    cost_class: float,
    cost_bbox: float,
    cost_giou: float,
    eos_coef: float,
):
    """DETR's set loss (Carion et al., arXiv:2005.12872 §2) per problem of
    the leading axes: Hungarian matching of the valid ground truth to the
    queries under the cost ``-p(class) * cost_class + L1 * cost_bbox -
    GIoU * cost_giou``, then the softmax cross-entropy of every query
    against its matched class (no-object for the rest, weighted
    ``eos_coef``) and L1 + (1 - GIoU) over the matched pairs. Returns the
    per-problem sums ``(ce_sum, ce_weight_sum, l1_sum, giou_sum,
    num_pos)``, each ``[...]``, for the batch-level normalization of
    ``DETR.loss``. A padding row's class is clamped into ``0..C`` for the
    cost (JAX's gathers clamp); its cost row is zeroed anyway."""
    num_queries, width = logits.shape[-2:]
    logits = logits.to(torch.float32)

    # --- matching cost [..., G, Q]; no gradient reaches the matcher.
    with torch.no_grad():
        probs = torch.softmax(logits, dim=-1)                 # [..., Q, C+1]
        cls_col = gt_classes.long().clamp(0, width - 1)
        c_class = -torch.gather(
            probs, -1, cls_col[..., None, :].expand(*probs.shape[:-1], -1)
        ).transpose(-1, -2)                                   # [..., G, Q]
        c_bbox = (gt_boxes[..., :, None, :]
                  - pred_boxes[..., None, :, :]).abs().sum(dim=-1)
        c_giou = -pairwise_giou(cxcywh_to_xyxy(gt_boxes),
                                cxcywh_to_xyxy(pred_boxes))
        cost = cost_class * c_class + cost_bbox * c_bbox + cost_giou * c_giou
        cost = torch.where(gt_valid[..., None], cost, torch.zeros_like(cost))
        match = hungarian_masked(cost, gt_valid)              # [..., G]

    # --- classification: CE over every query, eos_coef on no-object.
    tgt_cls = _target_classes(match, gt_classes, num_queries)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, tgt_cls[..., None])[..., 0]
    w = torch.where(tgt_cls > 0, torch.ones_like(ce),
                    torch.full_like(ce, eos_coef))
    l1_sum, giou_sum, num_pos = _matched_box_terms(pred_boxes, gt_boxes,
                                                   gt_valid, match)
    return (ce * w).sum(dim=-1), w.sum(dim=-1), l1_sum, giou_sum, num_pos


def deformable_detr_set_loss(
    logits: torch.Tensor,      # [..., Q, C] sigmoid class logits
    pred_boxes: torch.Tensor,  # [..., Q, 4] normalized (cx, cy, w, h)
    gt_boxes: torch.Tensor,    # [..., G, 4] normalized (cx, cy, w, h), padded
    gt_classes: torch.Tensor,  # [..., G] int 1..C (padding rows arbitrary)
    gt_valid: torch.Tensor,    # [..., G] bool
    cost_class: float,
    cost_bbox: float,
    cost_giou: float,
    alpha: float = 0.25,
    gamma: float = 2.0,
):
    """Deformable DETR's set loss (Zhu et al., arXiv:2010.04159 §4.4 and
    appendix A.4) per problem of the leading axes: Hungarian matching of
    the valid ground truth to the queries under the focal-style class cost
    plus L1 and -GIoU box costs, then sigmoid focal loss over every (query,
    class) element (matched queries target their ground truth's class,
    every other element zero) and L1 + (1 - GIoU) over the matched pairs.
    Returns the per-problem sums ``(focal_sum, l1_sum, giou_sum, num_pos)``,
    each ``[...]``.

    Two JAX idioms are written out: the matcher's sentinel ``Q`` for
    invalid rows is dropped from the class scatter (JAX's ``mode="drop"``)
    and clamped to ``Q - 1`` in the box gather (JAX's gathers clamp), whose
    rows the validity mask then zeroes; and the one-hot of class ``0``
    (background, index -1) is an all-zero row, as ``jax.nn.one_hot``'s."""
    num_queries, num_classes = logits.shape[-2:]
    logits = logits.to(torch.float32)
    p = torch.sigmoid(logits)

    # --- focal matching cost [..., G, Q]; no gradient reaches the matcher.
    with torch.no_grad():
        eps = 1e-8
        pos_cost = alpha * torch.pow(1.0 - p, gamma) * (-torch.log(p + eps))
        neg_cost = ((1.0 - alpha) * torch.pow(p, gamma)
                    * (-torch.log(1.0 - p + eps)))
        cls_col = (gt_classes.long() - 1).clamp(0, num_classes - 1)
        by_class = pos_cost - neg_cost                        # [..., Q, C]
        c_class = torch.gather(
            by_class, -1,
            cls_col[..., None, :].expand(*by_class.shape[:-1], -1)
        ).transpose(-1, -2)                                   # [..., G, Q]
        c_bbox = (gt_boxes[..., :, None, :]
                  - pred_boxes[..., None, :, :]).abs().sum(dim=-1)
        c_giou = -pairwise_giou(cxcywh_to_xyxy(gt_boxes),
                                cxcywh_to_xyxy(pred_boxes))
        cost = cost_class * c_class + cost_bbox * c_bbox + cost_giou * c_giou
        cost = torch.where(gt_valid[..., None], cost, torch.zeros_like(cost))
        match = hungarian_masked(cost, gt_valid)              # [..., G]

    # --- classification: sigmoid focal over every (query, class) ---------
    tgt_cls = _target_classes(match, gt_classes, num_queries)
    onehot = _one_hot(tgt_cls, num_classes, tgt_cls > 0)
    focal_sum = _focal(logits, onehot, alpha, gamma).sum(dim=(-2, -1))
    l1_sum, giou_sum, num_pos = _matched_box_terms(pred_boxes, gt_boxes,
                                                   gt_valid, match)
    return focal_sum, l1_sum, giou_sum, num_pos
