"""Detection losses (``tpudet.train.losses``): Faster R-CNN's RPN and
detection-head losses, Mask R-CNN's mask loss, Keypoint R-CNN's keypoint
loss, Panoptic FPN's semantic loss and the Deformable DETR set loss.

Each is JAX's per-image function with any leading axes (a batch of images
where JAX ``vmap``s): the reductions run over the last sample axis and the
results keep the leading ones. ``deformable_detr_set_loss`` is called once
over every (decoder layer, image) problem, so the matcher solves them all
in one lockstep batch.

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
over the batch). Every loss is 0, not NaN, where nothing is sampled.
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
    # The sentinel lands in an extra column that is then dropped.
    tgt_cls = torch.zeros((*match.shape[:-1], num_queries + 1),
                          dtype=torch.long, device=logits.device)
    tgt_cls = tgt_cls.scatter(-1, match, gt_classes.long())[..., :num_queries]
    classes = torch.arange(num_classes, device=logits.device)
    onehot = (((tgt_cls - 1)[..., None] == classes)
              & (tgt_cls > 0)[..., None]).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    bce = (torch.maximum(logits, zero) - logits * onehot
           + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * onehot + (1.0 - p) * (1.0 - onehot)
    alpha_t = alpha * onehot + (1.0 - alpha) * (1.0 - onehot)
    focal_sum = (alpha_t * torch.pow(1.0 - p_t, gamma) * bce).sum(dim=(-2, -1))

    # --- box terms on the matched valid pairs -----------------------------
    index = match.clamp(max=num_queries - 1)
    matched = torch.gather(pred_boxes, -2,
                           index[..., None].expand(*index.shape, 4))
    valid_f = gt_valid.to(torch.float32)
    l1 = (matched - gt_boxes).abs().sum(dim=-1)
    giou = elementwise_giou(cxcywh_to_xyxy(matched), cxcywh_to_xyxy(gt_boxes))
    l1_sum = (l1 * valid_f).sum(dim=-1)
    giou_sum = ((1.0 - giou) * valid_f).sum(dim=-1)
    num_pos = valid_f.sum(dim=-1)
    return focal_sum, l1_sum, giou_sum, num_pos
