"""Box geometry: area, IoU, GIoU, encode/decode, cxcywh conversions, clip
(``tpudet.ops.boxes``).

Boxes are ``[x1, y1, x2, y2]`` in absolute pixels; width is ``x2 - x1`` (no
+1). Deltas follow Faster R-CNN §3.1.2, optionally scaled per coordinate.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

# Clamp on dw/dh before exp, standard Fast R-CNN practice.
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [...]: box areas (0 for degenerate boxes). ``maximum``
    against a zero tensor, not ``clamp``: a tie at zero width splits the
    gradient as ``jnp.maximum``'s does."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    w = torch.maximum(boxes[..., 2] - boxes[..., 0], zero)
    h = torch.maximum(boxes[..., 3] - boxes[..., 1], zero)
    return w * h


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix between [..., N, 4] and [..., M, 4] boxes (leading axes
    broadcast) -> [..., N, M]; 0 where the union is empty."""
    a1 = area(boxes1)
    a2 = area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[..., :, None] + a2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def encode_boxes(
    boxes: torch.Tensor,
    anchors: torch.Tensor,
    weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Encode target ``boxes`` relative to ``anchors`` -> deltas [..., 4]."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    xa = anchors[..., 0] + 0.5 * wa
    ya = anchors[..., 1] + 0.5 * ha

    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    x = boxes[..., 0] + 0.5 * w
    y = boxes[..., 1] + 0.5 * h

    # Guard against degenerate anchors/boxes (padding rows): avoid div0/log0.
    wa = wa.clamp(min=1e-6)
    ha = ha.clamp(min=1e-6)
    w = w.clamp(min=1e-6)
    h = h.clamp(min=1e-6)

    wx, wy, ww, wh = weights
    tx = wx * (x - xa) / wa
    ty = wy * (y - ya) / ha
    tw = ww * torch.log(w / wa)
    th = wh * torch.log(h / ha)
    return torch.stack([tx, ty, tw, th], dim=-1)


def decode_boxes(
    deltas: torch.Tensor,
    anchors: torch.Tensor,
    weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Apply deltas [..., 4] to anchors [..., 4] -> boxes [..., 4]."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    xa = anchors[..., 0] + 0.5 * wa
    ya = anchors[..., 1] + 0.5 * ha

    wx, wy, ww, wh = weights
    tx = deltas[..., 0] / wx
    ty = deltas[..., 1] / wy
    tw = (deltas[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    th = (deltas[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)

    x = tx * wa + xa
    y = ty * ha + ya
    w = torch.exp(tw) * wa
    h = torch.exp(th) * ha
    return torch.stack(
        [x - 0.5 * w, y - 0.5 * h, x + 0.5 * w, y + 0.5 * h], dim=-1
    )


def elementwise_giou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """``[..., 4]`` broadcast pairs -> ``[...]`` generalized IoU
    (Rezatofighi et al., arXiv:1902.09630): IoU - |hull \\ union| / |hull|,
    in [-1, 1], in JAX's formula and order (``maximum``, as ``area``)."""
    zero = torch.zeros((), dtype=b1.dtype, device=b1.device)
    tiny = torch.full((), 1e-9, dtype=b1.dtype, device=b1.device)
    x1 = torch.maximum(b1[..., 0], b2[..., 0])
    y1 = torch.maximum(b1[..., 1], b2[..., 1])
    x2 = torch.minimum(b1[..., 2], b2[..., 2])
    y2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = torch.maximum(x2 - x1, zero) * torch.maximum(y2 - y1, zero)
    union = area(b1) + area(b2) - inter
    iou = inter / torch.maximum(union, tiny)
    hx1 = torch.minimum(b1[..., 0], b2[..., 0])
    hy1 = torch.minimum(b1[..., 1], b2[..., 1])
    hx2 = torch.maximum(b1[..., 2], b2[..., 2])
    hy2 = torch.maximum(b1[..., 3], b2[..., 3])
    hull = torch.maximum(hx2 - hx1, zero) * torch.maximum(hy2 - hy1, zero)
    return iou - (hull - union) / torch.maximum(hull, tiny)


def pairwise_giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """``[..., N, 4]`` x ``[..., M, 4]`` -> ``[..., N, M]`` GIoU of every
    pair (the DETR matching cost's term). JAX's function takes one ``[N,
    4]`` x ``[M, 4]`` pair; this one any leading axes."""
    return elementwise_giou(boxes1[..., :, None, :], boxes2[..., None, :, :])


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """Corner boxes -> (center_x, center_y, width, height), the DETR
    regression parameterization."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.stack(
        [boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h, w, h], dim=-1)


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(center_x, center_y, width, height) -> corner boxes."""
    cx, cy, w, h = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def clip_boxes(boxes: torch.Tensor, image_hw: torch.Tensor) -> torch.Tensor:
    """Clip boxes to [0, W] x [0, H]. ``image_hw`` is ``[..., 2]`` (height,
    width) and broadcasts against ``boxes[..., 0]``."""
    h, w = image_hw[..., 0], image_hw[..., 1]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def flip_boxes_horizontal(boxes: torch.Tensor, image_width) -> torch.Tensor:
    """Mirror boxes for a horizontally flipped image of ``image_width``
    (a number or a tensor broadcasting against ``boxes[..., 0]``)."""
    x1 = image_width - boxes[..., 2]
    x2 = image_width - boxes[..., 0]
    return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)
