"""Mask targets of the Mask R-CNN branch (``tpudet.ops.masks``).

Ground-truth masks arrive as box-frame crops (``gt_masks [B, G, M, M]``,
``data.masks``). Each sampled foreground RoI needs its matched instance's
crop resampled over the RoI's extent at the head's output size. The sample
grid is separable, so the resample is two small products per RoI, ``W_y
[s, M] @ crop [M, M] @ W_x^T [M, s]``, whose hat-function rows hold both
the bilinear weights and the zero padding outside the ground-truth box (a
coordinate outside [-1, M] gets a zero row). Batched ``torch.matmul`` over
every RoI of the batch; the JAX package leaves the same einsums to XLA,
outside any Pallas kernel.
"""

from __future__ import annotations

import torch


def _hat_weights(coords: torch.Tensor, m: int) -> torch.Tensor:
    """``[..., s]`` coordinates -> ``[..., s, m]`` rows of ``max(0, 1 -
    |coord - k|)`` over k = 0..m-1: the zero-padded bilinear kernel."""
    k = torch.arange(m, dtype=coords.dtype, device=coords.device)
    return (1.0 - (coords[..., None] - k).abs()).clamp(min=0.0)


def crop_mask_to_roi(gt_mask: torch.Tensor, gt_box: torch.Tensor,
                     roi: torch.Tensor, out_size: int) -> torch.Tensor:
    """Resample box-frame crops ``[..., M, M]`` (their frames ``gt_box``
    ``[..., 4]``) over ``roi`` ``[..., 4]`` -> ``[..., s, s]`` f32. Output
    pixel (i, j)'s centre is the RoI-frame point ``y1 + (i + 0.5) * h / s``;
    values outside the ground-truth box are zero."""
    m = gt_mask.shape[-1]
    dev = roi.device
    s = torch.full((), float(out_size), device=dev)
    idx = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    x1g, y1g, x2g, y2g = (gt_box[..., i, None] for i in range(4))
    wg = (x2g - x1g).clamp(min=1e-4)
    hg = (y2g - y1g).clamp(min=1e-4)
    ys = roi[..., 1, None] + idx * (roi[..., 3, None] - roi[..., 1, None]) / s
    xs = roi[..., 0, None] + idx * (roi[..., 2, None] - roi[..., 0, None]) / s
    # Image coordinates -> crop pixel coordinates (crop pixel k's centre is
    # at y1g + (k + 0.5) * hg / M).
    v = (ys - y1g) * m / hg - 0.5
    u = (xs - x1g) * m / wg - 0.5
    wy = _hat_weights(v, m)  # [..., s, M]
    wx = _hat_weights(u, m)
    return wy @ gt_mask.to(torch.float32) @ wx.transpose(-1, -2)


def mask_targets(gt_masks: torch.Tensor, gt_boxes: torch.Tensor,
                 rois: torch.Tensor, matched_gt: torch.Tensor,
                 out_size: int) -> torch.Tensor:
    """Binary mask targets ``[B, R, s, s]`` (resampled, then ``>= 0.5``) of
    the RoIs ``[B, R, 4]`` from their matched instances (``matched_gt [B,
    R]`` indexes ``gt_masks [B, G, M, M]`` and ``gt_boxes [B, G, 4]``).
    Background and invalid rows get targets too, which the loss masks out,
    so the shapes stay static."""
    rows = torch.arange(gt_masks.shape[0], device=gt_masks.device)[:, None]
    matched = matched_gt.long()
    crops = gt_masks[rows, matched]  # [B, R, M, M]
    boxes = gt_boxes[rows, matched].to(torch.float32)
    resampled = crop_mask_to_roi(crops, boxes, rois, out_size)
    return (resampled >= 0.5).to(torch.float32)
