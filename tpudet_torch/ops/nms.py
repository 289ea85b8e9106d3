"""Non-maximum suppression, plain PyTorch versions (``tpudet.ops.nms``).

Exact greedy NMS: sort by score descending with ties toward the lower
index, then keep a box iff no previously kept box overlaps it with IoU above
the threshold. Output shapes are static: ``[max_outputs]`` indices plus a
validity mask, invalid slots pointing at index 0.

Every function takes one image (``boxes [N, 4]``, ``scores [N]``) or a batch
(``boxes [B, N, 4]``, ``scores [B, N]``) and returns the matching rank.
These are the CPU path and the reference of the Hopper kernel in
``tpudet_torch.kernels.nms``, which must give the same indices bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e10


def _f32(x: float, device) -> torch.Tensor:
    """A float32 scalar tensor: thresholds compare in f32, as in JAX (0.7
    rounded to f32 is not 0.7 in double). A fill on the device, not a copy
    from the host, so a CUDA graph can capture it."""
    return torch.full((), x, dtype=torch.float32, device=device)


def masked_scores(scores, valid_mask=None, score_threshold=None):
    """Scores with masked and sub-threshold entries set to ``NEG_INF``."""
    neg = _f32(NEG_INF, scores.device)
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores, neg)
    if score_threshold is not None:
        scores = torch.where(scores > _f32(score_threshold, scores.device),
                             scores, neg)
    return scores


def sort_desc(scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending sort along the last axis with ``lax.top_k``'s tie order
    (lower index first). ``torch.topk`` promises no tie order."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)


def iou_above(earlier: torch.Tensor, later: torch.Tensor,
              iou_threshold: float) -> torch.Tensor:
    """``IoU(earlier[..., i], later[..., j]) > thr`` as ``[..., I, J]`` bool,
    in f32 with the operation order of ``tpudet/kernels/nms.py::_iou_block``
    (the CUDA kernel repeats it, rounding each step)."""
    rx1, ry1, rx2, ry2 = (earlier[..., :, None, k] for k in range(4))
    cx1, cy1, cx2, cy2 = (later[..., None, :, k] for k in range(4))
    iw = (torch.minimum(rx2, cx2) - torch.maximum(rx1, cx1)).clamp(min=0.0)
    ih = (torch.minimum(ry2, cy2) - torch.maximum(ry1, cy1)).clamp(min=0.0)
    inter = iw * ih
    ra = (rx2 - rx1).clamp(min=0.0) * (ry2 - ry1).clamp(min=0.0)
    ca = (cx2 - cx1).clamp(min=0.0) * (cy2 - cy1).clamp(min=0.0)
    union = ra + ca - inter
    iou = torch.where(union > 0.0, inter / union, torch.zeros_like(inter))
    return iou > _f32(iou_threshold, iou.device)


def greedy_keep(boxes_sorted: torch.Tensor, candidate: torch.Tensor,
                iou_threshold: float) -> torch.Tensor:
    """Score-sorted ``[B, P, 4]`` boxes + ``[B, P]`` candidate mask ->
    ``[B, P]`` keep mask of exact greedy NMS."""
    b, p = candidate.shape
    # [B, P, P] suppression matrix, built 512 rows at a time so the f32
    # intermediates stay small at the 6000-box proposal shape.
    over = torch.cat([
        iou_above(boxes_sorted[:, r:r + 512], boxes_sorted, iou_threshold)
        for r in range(0, p, 512)
    ], dim=1)
    keep = torch.zeros_like(candidate)
    removed = torch.zeros_like(candidate)
    for i in range(p):
        keep_i = candidate[:, i] & ~removed[:, i]
        keep[:, i] = keep_i
        removed |= over[:, i, :] & keep_i[:, None]
    return keep


def _select_kept(keep: torch.Tensor, order: torch.Tensor, max_outputs: int):
    """Sorted keep mask ``[B, P]`` + sort order -> ``(indices [B, max_outputs]
    int32, valid)``: the first ``max_outputs`` kept boxes in score order.
    Slots past ``P`` are invalid (the output shape is always
    ``[max_outputs]``)."""
    b, n = keep.shape
    k = min(max_outputs, n)
    rank = torch.arange(n, 0, -1, dtype=torch.int32, device=keep.device)
    priority = torch.where(keep, rank, torch.zeros_like(rank))
    top_priority, positions = sort_desc(priority)
    top_priority, positions = top_priority[:, :k], positions[:, :k]
    valid = top_priority > 0
    picked = torch.gather(order, 1, positions)
    indices = torch.where(valid, picked, torch.zeros_like(picked)).to(torch.int32)
    if k < max_outputs:
        pad = max_outputs - k
        indices = torch.cat([indices, indices.new_zeros(b, pad)], dim=1)
        valid = torch.cat([valid, valid.new_zeros(b, pad)], dim=1)
    return indices, valid


def _batched(boxes, scores, *masks):
    """Lift one image to a batch of one; returns (boxes, scores, masks,
    squeeze)."""
    if boxes.dim() == 2:
        return (boxes[None], scores[None],
                tuple(None if m is None else m[None] for m in masks), True)
    return boxes, scores, masks, False


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_outputs: int,
    valid_mask: Optional[torch.Tensor] = None,
    score_threshold: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS -> ``(indices [.., max_outputs] int32, valid bool)``:
    indices into the input order, highest score first."""
    boxes, scores, (valid_mask,), squeeze = _batched(boxes, scores, valid_mask)
    scores = masked_scores(scores, valid_mask, score_threshold)
    sorted_scores, order = sort_desc(scores)
    candidate = sorted_scores > _f32(NEG_INF / 2, scores.device)
    boxes_sorted = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    keep = greedy_keep(boxes_sorted, candidate, iou_threshold)
    indices, valid = _select_kept(keep, order, max_outputs)
    if squeeze:
        return indices[0], valid[0]
    return indices, valid


def coordinate_offset_for(max_coord: float) -> float:
    """Class-offset stride for :func:`batched_nms`: the next power of two
    above ``max_coord``, at least 4096, so shifted class bands never overlap
    and the shift stays exact in f32."""
    out = 4096.0
    while out <= max_coord:
        out *= 2.0
    return out


def class_offset_boxes(boxes: torch.Tensor, class_ids: torch.Tensor,
                       coordinate_offset: float) -> torch.Tensor:
    """Shift each box by ``class_id * offset`` in the boxes' dtype (f32), as
    ``tpudet/kernels/__init__.py:103`` does, so IoU rounds the same way."""
    offsets = class_ids.to(boxes.dtype)[..., None] * coordinate_offset
    return boxes + offsets


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    class_ids: torch.Tensor,
    iou_threshold: float,
    max_outputs: int,
    valid_mask: Optional[torch.Tensor] = None,
    score_threshold: Optional[float] = None,
    coordinate_offset: float = 4096.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class NMS in one pass via the class-offset trick."""
    return nms(
        class_offset_boxes(boxes, class_ids, coordinate_offset),
        scores, iou_threshold, max_outputs,
        valid_mask=valid_mask, score_threshold=score_threshold,
    )


def _iou_one_vs_many(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of ``[B, 4]`` boxes against their image's ``[B, N, 4]`` -> ``[B,
    N]``, in f32 with ``tpudet/ops/nms.py::_iou_one_vs_many``'s operation
    order."""
    box = box[:, None, :]
    a1 = ((box[..., 2] - box[..., 0]).clamp(min=0.0)
          * (box[..., 3] - box[..., 1]).clamp(min=0.0))
    a2 = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
          * (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0))
    lt = torch.maximum(box[..., :2], boxes[..., :2])
    rb = torch.minimum(box[..., 2:], boxes[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1 + a2 - inter
    return torch.where(union > 0.0, inter / union, torch.zeros_like(inter))


def soft_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_outputs: int,
    method: str = "gaussian",
    sigma: float = 0.5,
    valid_mask: Optional[torch.Tensor] = None,
    prune_threshold: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Soft-NMS (Bodla et al., arXiv:1704.04503): each of ``max_outputs``
    steps picks the highest live score (the first on a tie), then decays
    the others by their IoU with the pick: ``gaussian`` ``exp(-iou^2 /
    sigma)``, ``linear`` ``1 - iou`` where ``iou > iou_threshold``.

    Returns ``(indices [.., max_outputs] int32, rescored [..,
    max_outputs], valid)``: the picks' decayed scores, non-increasing. A
    pick is valid iff its score exceeds ``prune_threshold``; the invalid
    ones form a suffix pointing at index 0 with score 0. Dead entries hold
    ``NEG_INF`` and are never decayed (a sentinel times a decay near 0
    would not stay dead). Plain PyTorch on every device, batched over
    images: an accuracy knob, not the throughput path (the JAX package has
    no Pallas form of it either)."""
    if method not in ("linear", "gaussian"):
        raise ValueError(f"soft_nms method must be 'linear' or 'gaussian', "
                         f"got {method!r}")
    boxes, scores, (valid_mask,), squeeze = _batched(boxes, scores, valid_mask)
    device = scores.device
    dead = _f32(NEG_INF, device)
    s = scores.float()
    if valid_mask is not None:
        s = torch.where(valid_mask, s, dead)
    boxes = boxes.float()
    thr, sig = _f32(iou_threshold, device), _f32(sigma, device)
    one = _f32(1.0, device)
    rows = torch.arange(s.shape[0], device=device)
    picks, picked = [], []
    for _ in range(max_outputs):
        i = torch.argmax(s, dim=-1)
        picked.append(s[rows, i])
        picks.append(i)
        iou = _iou_one_vs_many(boxes[rows, i], boxes)
        if method == "linear":
            decay = torch.where(iou > thr, one - iou, one)
        else:
            decay = torch.exp(-(iou * iou) / sig)
        s = torch.where(s > dead / 2, s * decay, dead)
        s = s.index_put((rows, i), dead)
    idx = torch.stack(picks, dim=-1).to(torch.int32)
    picked = torch.stack(picked, dim=-1)
    valid = picked > _f32(prune_threshold, device)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    picked = torch.where(valid, picked, torch.zeros_like(picked))
    if squeeze:
        return idx[0], picked[0], valid[0]
    return idx, picked, valid


def batched_soft_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    class_ids: torch.Tensor,
    iou_threshold: float,
    max_outputs: int,
    method: str = "gaussian",
    sigma: float = 0.5,
    valid_mask: Optional[torch.Tensor] = None,
    prune_threshold: float = 0.0,
    coordinate_offset: float = 4096.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class Soft-NMS through the class offset: boxes of two classes
    have IoU 0, so they never decay each other (``exp(0) = 1``, and ``1 -
    0`` is never above the threshold)."""
    return soft_nms(
        class_offset_boxes(boxes, class_ids, coordinate_offset),
        scores, iou_threshold, max_outputs, method=method, sigma=sigma,
        valid_mask=valid_mask, prune_threshold=prune_threshold,
    )
