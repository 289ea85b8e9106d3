"""Anchor grid generation (``tpudet.ops.anchors``; Faster R-CNN §3.1.1).

Anchors are a pure function of static shapes, so they are built with NumPy
once per canvas and moved to the device by the caller.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def base_anchors_np(
    scales: Sequence[float], aspect_ratios: Sequence[float]
) -> np.ndarray:
    """[A, 4] zero-centered base anchors, scale varying slowest:
    [(s0,r0), (s0,r1), ..., (s1,r0), ...]. For ratio r (h/w) the anchor is
    ``w = s / sqrt(r)``, ``h = s * sqrt(r)``."""
    out = []
    for s in scales:
        for r in aspect_ratios:
            w = s / np.sqrt(r)
            h = s * np.sqrt(r)
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, dtype=np.float32)


def generate_anchors_np(
    feat_height: int,
    feat_width: int,
    stride: int,
    scales: Sequence[float],
    aspect_ratios: Sequence[float],
) -> np.ndarray:
    """[H*W*A, 4] anchor grid in input-image pixels, row-major over (y, x, a)."""
    base = base_anchors_np(scales, aspect_ratios)  # [A, 4]
    cx = (np.arange(feat_width, dtype=np.float32) + 0.5) * stride
    cy = (np.arange(feat_height, dtype=np.float32) + 0.5) * stride
    cxv, cyv = np.meshgrid(cx, cy)  # [H, W]
    centers = np.stack([cxv, cyv, cxv, cyv], axis=-1)  # [H, W, 4]
    anchors = centers[:, :, None, :] + base[None, None, :, :]  # [H, W, A, 4]
    return anchors.reshape(-1, 4)


def generate_fpn_anchors(
    feat_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    scales: Sequence[float],
    aspect_ratios: Sequence[float],
) -> Tuple[np.ndarray, List[int]]:
    """Multi-level anchors, one scale per level and every ratio -> (anchors
    [sum_l H_l*W_l*A, 4] in level order, the per-level counts)."""
    assert len(feat_shapes) == len(strides) == len(scales)
    per_level = [generate_anchors_np(fh, fw, stride, [scale], aspect_ratios)
                 for (fh, fw), stride, scale in zip(feat_shapes, strides,
                                                    scales)]
    return (np.concatenate(per_level, axis=0),
            [a.shape[0] for a in per_level])


def generate_points_np(feat_height: int, feat_width: int,
                       stride: int) -> np.ndarray:
    """[H*W, 2] anchor-free location grid (FCOS, arXiv:1904.01355 §3.1):
    each feature cell's centre in image pixels, (x, y), row-major over
    (y, x)."""
    cx = (np.arange(feat_width, dtype=np.float32) + 0.5) * stride
    cy = (np.arange(feat_height, dtype=np.float32) + 0.5) * stride
    cxv, cyv = np.meshgrid(cx, cy)  # [H, W]
    return np.stack([cxv, cyv], axis=-1).reshape(-1, 2)


def anchor_validity_mask_np(anchors, image_height, image_width):
    """True for anchors fully inside the image (Faster R-CNN §3.1.3: ignore
    cross-boundary anchors during training). Takes NumPy arrays or tensors;
    ``image_height``/``image_width`` of shape ``[B, 1]`` give ``[B, N]``."""
    return (
        (anchors[..., 0] >= 0)
        & (anchors[..., 1] >= 0)
        & (anchors[..., 2] <= image_width)
        & (anchors[..., 3] <= image_height)
    )
