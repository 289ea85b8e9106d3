"""Test-time augmentation, the eval CLI's ``--tta hflip``
(``tpudet.eval.tta``): predict on each canvas and on its mirror, map the
mirror's detections back, and merge the two sets with a per-class greedy
NMS (Detectron's TEST.AUG recipe).

The flip runs on the model's device (one more predict per batch); the
unflip and the merge run on the host in NumPy beside the evaluator, where
each image has at most ``2 * max_detections`` candidates. Masks unflip by
mirroring the box-frame crop; keypoints mirror x and swap
``keypoint_flip_pairs``, the inverses of the training flip.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from tpudet_torch.data.preprocess import flip_image


def flip_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch with each canvas's valid region mirrored (its padded
    columns stay in place)."""
    out = dict(batch)
    out["image"] = flip_image(batch["image"], batch["image_hw"])
    return out


def unflip_detections(out: Dict[str, np.ndarray], image_hw: np.ndarray,
                      flip_pairs: Sequence[Tuple[int, int]] = ()
                      ) -> Dict[str, np.ndarray]:
    """A mirrored canvas's batched predictions (host arrays) -> the
    original canvas's coordinates."""
    res = dict(out)
    w = np.asarray(image_hw)[:, 1][:, None]  # [B, 1]
    b = out["boxes"]
    res["boxes"] = np.stack(
        [w - b[:, :, 2], b[:, :, 1], w - b[:, :, 0], b[:, :, 3]], axis=-1)
    if "masks" in out:
        res["masks"] = out["masks"][:, :, :, ::-1]
    if "keypoints" in out:
        kp = out["keypoints"].copy()
        kp[:, :, :, 0] = w[:, :, None] - kp[:, :, :, 0]
        if flip_pairs:
            perm = np.arange(kp.shape[2])
            for a_i, b_i in flip_pairs:
                perm[a_i], perm[b_i] = perm[b_i], perm[a_i]
            kp = kp[:, :, perm, :]
        res["keypoints"] = kp
    return res


def _nms_greedy(boxes: np.ndarray, scores: np.ndarray,
                thresh: float) -> np.ndarray:
    """Indices kept by greedy NMS (stable order on ties), on the host."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    areas = ((boxes[:, 2] - boxes[:, 0]).clip(0)
             * (boxes[:, 3] - boxes[:, 1]).clip(0))
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        x1 = np.maximum(boxes[i, 0], boxes[:, 0])
        y1 = np.maximum(boxes[i, 1], boxes[:, 1])
        x2 = np.minimum(boxes[i, 2], boxes[:, 2])
        y2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = (x2 - x1).clip(0) * (y2 - y1).clip(0)
        union = areas[i] + areas - inter
        iou = np.divide(inter, union, out=np.zeros_like(inter),
                        where=union > 0)
        suppressed |= iou > thresh
    return np.asarray(keep, np.int64)


def merge_detections(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
                     image_index: int, nms_thresh: float,
                     max_detections: int) -> Dict[str, np.ndarray]:
    """One image's two candidate sets (the original and the unflipped
    mirror): their valid rows, a per-class greedy NMS, the top
    ``max_detections`` by score. Unbatched arrays (boxes ``[n, 4]``, scores,
    classes, and masks and keypoints where present)."""
    i = image_index
    fields: Dict[str, list] = {}
    for src in (a, b):
        v = src["valid"][i]
        for k in ("boxes", "scores", "classes", "masks", "keypoints"):
            if k in src:
                fields.setdefault(k, []).append(np.asarray(src[k][i])[v])
    cat = {k: np.concatenate(vs, axis=0) for k, vs in fields.items()}
    boxes, scores, classes = cat["boxes"], cat["scores"], cat["classes"]
    keep_all = []
    for c in np.unique(classes):
        idx = np.flatnonzero(classes == c)
        keep_all.append(idx[_nms_greedy(boxes[idx], scores[idx], nms_thresh)])
    keep = np.concatenate(keep_all) if keep_all else np.zeros(0, np.int64)
    keep = keep[np.argsort(-scores[keep], kind="stable")][:max_detections]
    return {k: v[keep] for k, v in cat.items()}


def tta_knobs(cfg) -> Tuple[float, int]:
    """(nms_thresh, max_detections) of the family's final selection: the
    merge runs the same suppression over the doubled candidate set."""
    group = {"retinanet": cfg.retinanet, "fcos": cfg.fcos}.get(cfg.model,
                                                              cfg.roi)
    return group.nms_thresh, group.max_detections
