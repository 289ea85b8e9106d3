"""IoU-based target assignment (``tpudet.ops.matchers``).

One matcher serves both stages:

* RPN (Faster R-CNN §3.1.2): positive if IoU >= fg or the anchor has the
  highest IoU with some ground-truth box (``allow_low_quality``, ties
  included); negative below bg; otherwise ignored.
* Detection head (Fast R-CNN §2.3): foreground at IoU >= fg, background in
  ``[bg_lo, bg)``, ignored below ``bg_lo``.

Ground truth arrives padded with a validity mask; padding columns are
excluded by forcing their IoU to -1. Any leading batch axes are allowed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar: thresholds compare in f32, as JAX's weak-typed
    Python floats do."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def match_boxes(
    iou: torch.Tensor,
    fg_thresh: float,
    bg_thresh: float,
    gt_valid: Optional[torch.Tensor] = None,
    allow_low_quality: bool = False,
    bg_thresh_lo: float = -1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match rows (anchors or proposals) of ``iou [..., N, G]`` to columns
    (ground truth) -> ``(matched_idx [..., N] int32`` (the first column of
    the largest IoU, as ``jnp.argmax``), ``labels [..., N] int32`` (1
    positive, 0 negative, -1 ignored)``)``. With no valid ground truth
    every label is 0."""
    if gt_valid is not None:
        iou = torch.where(gt_valid[..., None, :], iou, _f32(-1.0, iou))

    # torch.argmax returns the first maximal index, as jnp.argmax does.
    matched_idx = torch.argmax(iou, dim=-1).to(torch.int32)
    max_iou = iou.max(dim=-1).values

    labels = torch.full(max_iou.shape, -1, dtype=torch.int32,
                        device=iou.device)
    is_neg = (max_iou < _f32(bg_thresh, iou)) & (max_iou >= _f32(bg_thresh_lo, iou))
    labels = torch.where(is_neg, torch.zeros_like(labels), labels)
    labels = torch.where(max_iou >= _f32(fg_thresh, iou),
                         torch.ones_like(labels), labels)

    if allow_low_quality:
        per_gt_max = iou.max(dim=-2, keepdim=True).values  # [..., 1, G]
        is_best = (iou == per_gt_max) & (per_gt_max > 0)
        if gt_valid is not None:
            is_best = is_best & gt_valid[..., None, :]
        labels = torch.where(is_best.any(dim=-1), torch.ones_like(labels),
                             labels)

    if gt_valid is not None:
        no_gt = ~gt_valid.any(dim=-1, keepdim=True)
        labels = torch.where(no_gt, torch.zeros_like(labels), labels)
    return matched_idx, labels
