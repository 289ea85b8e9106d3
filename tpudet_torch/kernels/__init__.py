"""Hand-written Hopper kernels of the detection path and their dispatch
(``tpudet.kernels``).

Dispatch goes by the tensor's device only: a CUDA tensor goes to the
kernel (which launches or raises), a CPU tensor to the plain PyTorch version
beside it. Nothing falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpudet_torch.kernels.nms import nms_keep
from tpudet_torch.ops.nms import (
    NEG_INF,
    _batched,
    _f32,
    batched_soft_nms,
    class_offset_boxes,
    masked_scores,
    sort_desc,
)


def nms_dispatch(boxes, scores, iou_threshold: float, max_outputs: int,
                 valid_mask: Optional[torch.Tensor] = None,
                 score_threshold: Optional[float] = None,
                 presorted: bool = False):
    """Greedy NMS with the contract of ``tpudet_torch.ops.nms.nms`` (one
    image or a batch).

    ``presorted`` promises descending scores (the proposal top-k output):
    the sort and the box gather are skipped, and masked entries become
    non-candidates in place. The selection is the same either way."""
    boxes, scores, (valid_mask,), squeeze = _batched(boxes, scores, valid_mask)
    scores = masked_scores(scores, valid_mask, score_threshold)
    if presorted:
        order = None
        candidate = scores > _f32(NEG_INF / 2, scores.device)
        boxes_sorted = boxes
    else:
        sorted_scores, order = sort_desc(scores)
        candidate = sorted_scores > _f32(NEG_INF / 2, scores.device)
        boxes_sorted = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    positions, valid = nms_keep(boxes_sorted.contiguous(), candidate,
                                iou_threshold, max_outputs)
    picked = positions.long() if order is None else torch.gather(
        order, 1, positions.long())
    indices = torch.where(valid, picked, torch.zeros_like(picked)).to(torch.int32)
    if squeeze:
        return indices[0], valid[0]
    return indices, valid


def batched_nms_dispatch(boxes, scores, class_ids, iou_threshold: float,
                         max_outputs: int,
                         valid_mask: Optional[torch.Tensor] = None,
                         score_threshold: Optional[float] = None,
                         coordinate_offset: float = 4096.0):
    """Per-class NMS via the class-offset trick: each box shifts by
    ``class_id * coordinate_offset`` in f32, exactly as
    ``tpudet/kernels/__init__.py:103``, then one greedy NMS."""
    return nms_dispatch(
        class_offset_boxes(boxes, class_ids, coordinate_offset),
        scores, iou_threshold, max_outputs,
        valid_mask=valid_mask, score_threshold=score_threshold,
    )


def class_aware_select(boxes, scores, class_ids, iou_threshold: float,
                       max_outputs: int, *, method: str = "hard",
                       sigma: float = 0.5, prune_threshold: float = 0.0,
                       valid_mask: Optional[torch.Tensor] = None,
                       coordinate_offset: float = 4096.0):
    """One class-aware selection over flat (box, score, class) candidates ->
    ``(indices [.., D] int32, scores [.., D], valid [.., D])``, scores zeroed
    where invalid: the original scores of greedy NMS (``method="hard"``,
    the NMS kernel on the card), or the decayed scores of Soft-NMS
    (``"soft_linear"``, ``"soft_gaussian"``: ``ops.nms.batched_soft_nms``,
    plain PyTorch on every device, chosen by the config as in the JAX
    package)."""
    if method in ("soft_linear", "soft_gaussian"):
        return batched_soft_nms(
            boxes, scores, class_ids, iou_threshold, max_outputs,
            method=method.removeprefix("soft_"), sigma=sigma,
            valid_mask=valid_mask, prune_threshold=prune_threshold,
            coordinate_offset=coordinate_offset)
    if method != "hard":
        raise ValueError(
            f"nms_method must be 'hard', 'soft_linear' or 'soft_gaussian', "
            f"got {method!r}"
        )
    keep, valid = batched_nms_dispatch(
        boxes, scores, class_ids, iou_threshold, max_outputs,
        valid_mask=valid_mask, coordinate_offset=coordinate_offset,
    )
    kept_scores = torch.gather(scores, -1, keep.long())
    return keep, torch.where(valid, kept_scores, torch.zeros_like(kept_scores)), valid
