"""Detection losses (``tpudet.train.losses``): the Deformable DETR set loss.

``deformable_detr_set_loss`` is JAX's per-image function with any leading
axes: the model calls it once over every (decoder layer, image) problem,
where JAX ``vmap``s the per-image function, so the matcher solves them all
in one lockstep batch.
"""

from __future__ import annotations

import torch

from tpudet_torch.ops.boxes import (
    cxcywh_to_xyxy,
    elementwise_giou,
    pairwise_giou,
)
from tpudet_torch.ops.hungarian import hungarian_masked


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
