"""VOC-style mAP evaluator (``tpudet.eval.metrics``, a copy: a test holds
it equal to the original) — host-side NumPy, deliberately kept off the
device: it is the parity referee, so it follows the canonical VOC protocol
exactly rather than a tensorized approximation.

Protocols:
  * ``mode="voc"`` — PASCAL devkit semantics: each detection (descending
    score) takes its single best-IoU GT whether or not that GT is already
    matched; if that GT is difficult the detection is dropped, if it was
    already matched the detection is a false positive.
  * ``mode="coco"`` — pycocotools semantics: a detection matches the best
    unmatched non-ignored GT clearing the threshold; only if none exists may
    it match an ignored GT (crowd GT stay rematchable, and IoU against a
    crowd uses the detection's area as denominator); detections matched to
    ignored GT are dropped, unmatched detections outside the area range are
    ignored rather than counted as false positives.
  * GT marked difficult/crowd/out-of-area-range neither count toward npos
    nor penalize matches.
  * AP: 11-point interpolation (VOC2007), all-point area-under-PR-envelope
    (VOC2010+), or pycocotools 101-point sampling.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _iou_matrix(
    a: np.ndarray, b: np.ndarray, crowd_b: Optional[np.ndarray] = None
) -> np.ndarray:
    """Pairwise IoU [len(a), len(b)]. Columns flagged in ``crowd_b`` use the
    pycocotools crowd convention: intersection over the *detection* area
    (a crowd region is a may-cover mask, not a box to be reproduced)."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    if crowd_b is not None and crowd_b.any():
        union = np.where(crowd_b[None, :], area_a[:, None], union)
    return np.divide(inter, union, out=np.zeros_like(inter),
                     where=union > 0)


def _paste_for_segm(pred_boxes, pred_masks, gt_boxes, gt_masks):
    """Paste box-frame masks once per image for segm-IoU evaluation.

    Returns (pasted_dets, pasted_gts, det_areas, gt_areas) — areas are mask
    pixel counts (pycocotools computes segm areas from the mask RLE, not the
    box). Deviation note: GT here is the loader's fixed-resolution box-frame
    crop, so areas/IoUs are those of the re-pasted crop rather than the
    original full-resolution polygon — at gt_mask_size=112 the discrepancy
    is sub-pixel for typical objects."""
    from tpudet_torch.data.masks import paste_mask, pasted_area

    if pred_masks is None or gt_masks is None:
        raise ValueError(
            "iou_type='segm' needs pred_masks and gt_masks in add_image"
        )
    pd = [paste_mask(m, b) for m, b in zip(pred_masks, pred_boxes)]
    pg = [paste_mask(m, b) for m, b in zip(gt_masks, gt_boxes)]
    d_areas = np.asarray([pasted_area(p) for p in pd])
    g_areas = np.asarray([pasted_area(p) for p in pg])
    return pd, pg, d_areas, g_areas


def _segm_iou(pasted_d, pasted_g, det_mask, order, gt_mask, g_crowd):
    """Per-class segm-IoU matrix from the image's pre-pasted masks:
    subset detections (score-ordered) and GT of this class."""
    from tpudet_torch.data.masks import pasted_iou_matrix

    d_idx = np.flatnonzero(det_mask)[order]
    g_idx = np.flatnonzero(gt_mask)
    return pasted_iou_matrix(
        [pasted_d[i] for i in d_idx],
        [pasted_g[j] for j in g_idx],
        g_crowd,
    )


def _oks_matrix(pred_kps, gt_kps, gt_boxes, gt_areas, sigmas):
    """[D, G] object-keypoint-similarity matrix (pycocotools computeOks):
    ks(d, g) = mean over g's LABELED keypoints of exp(-dist² / (2 s² κ²))
    with per-keypoint constants κ = 2·sigma and scale s² = the GT's area.

    GT with ZERO labeled keypoints (crowds, unlabeled persons) use
    pycocotools' fallback: per-detection-keypoint distance to the GT box
    expanded by its own width/height on each side, averaged over ALL K —
    this is what lets a detection over an ignore region match-ignore it
    instead of counting as a false positive (``gt_boxes`` x1y1x2y2)."""
    sig = np.asarray(sigmas, np.float64)
    k = len(sig)
    pred_kps = np.asarray(pred_kps, np.float64).reshape(len(pred_kps), k, 3)
    gt_kps = np.asarray(gt_kps, np.float64).reshape(len(gt_kps), k, 3)
    gt_boxes = np.asarray(gt_boxes, np.float64).reshape(len(gt_kps), 4)
    var = (2.0 * sig) ** 2  # [K]
    vis = gt_kps[:, :, 2] > 0  # [G, K]
    xd = pred_kps[:, None, :, 0]  # [D, 1, K]
    yd = pred_kps[:, None, :, 1]
    dx = xd - gt_kps[None, :, :, 0]  # [D, G, K]
    dy = yd - gt_kps[None, :, :, 1]
    # k1 == 0 fallback: distance OUTSIDE the 2x-expanded GT box.
    bw = gt_boxes[:, 2] - gt_boxes[:, 0]
    bh = gt_boxes[:, 3] - gt_boxes[:, 1]
    ex0 = (gt_boxes[:, 0] - bw)[None, :, None]
    ex1 = (gt_boxes[:, 2] + bw)[None, :, None]
    ey0 = (gt_boxes[:, 1] - bh)[None, :, None]
    ey1 = (gt_boxes[:, 3] + bh)[None, :, None]
    fdx = np.maximum(0.0, ex0 - xd) + np.maximum(0.0, xd - ex1)
    fdy = np.maximum(0.0, ey0 - yd) + np.maximum(0.0, yd - ey1)
    has_vis = vis.any(axis=1)  # [G]
    dx = np.where(has_vis[None, :, None], dx, fdx)
    dy = np.where(has_vis[None, :, None], dy, fdy)
    d2 = dx * dx + dy * dy
    denom = var[None, None, :] * (
        np.asarray(gt_areas, np.float64)[None, :, None] + np.spacing(1.0)
    ) * 2.0
    use = np.where(has_vis[:, None], vis, True)  # [G, K]
    e = np.exp(-d2 / denom) * use[None, :, :]
    cnt = np.maximum(use.sum(axis=1), 1)  # [G]
    return e.sum(axis=2) / cnt[None, :]


def _match_dets(
    iou: Optional[np.ndarray],   # [D, G] for this class (score-sorted rows)
    g_ignore: np.ndarray,        # [G]
    g_crowd: np.ndarray,         # [G]
    d_oor: np.ndarray,           # [D] detection outside area range
    thresh: float,
    mode: str,
) -> np.ndarray:
    """Greedy per-class matching over detections already sorted by descending
    score. Returns an int8 code per detection: 1 = true positive, 0 = false
    positive, -1 = ignored (matched an ignored GT, or out-of-range unmatched
    in COCO mode)."""
    D = len(d_oor)
    G = iou.shape[1] if iou is not None else 0
    codes = np.zeros(D, np.int8)
    matched = np.zeros(G, bool)
    for di in range(D):
        if G == 0:
            codes[di] = -1 if (mode == "coco" and d_oor[di]) else 0
            continue
        row = iou[di]
        if mode == "voc":
            # Devkit: argmax over ALL GT of the class (MATLAB max → first
            # index on ties), then resolve against that one GT only.
            j = int(np.argmax(row))
            if row[j] >= thresh:
                if g_ignore[j]:
                    codes[di] = -1
                elif not matched[j]:
                    matched[j] = True
                    codes[di] = 1
            continue
        cand = row >= thresh
        real = cand & ~g_ignore & ~matched
        if real.any():
            # pycocotools iterates GT in order and displaces on >=, so equal
            # IoU goes to the LATER GT index.
            vals = np.where(real, row, -1.0)
            j = G - 1 - int(np.argmax(vals[::-1]))
            matched[j] = True
            codes[di] = 1
        else:
            # Only when no real GT clears the threshold may a detection fall
            # onto an ignored GT (never displacing: ignored GT sort last in
            # pycocotools). Crowd GT absorb any number of detections.
            ig = cand & g_ignore & (~matched | g_crowd)
            if ig.any():
                vals = np.where(ig, row, -1.0)
                j = G - 1 - int(np.argmax(vals[::-1]))
                matched[j] = True
                codes[di] = -1
            elif d_oor[di]:
                codes[di] = -1
    return codes


def _box_areas(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, np.float64).reshape(-1, 4)
    return (np.maximum(b[:, 2] - b[:, 0], 0)
            * np.maximum(b[:, 3] - b[:, 1], 0))


def average_precision(
    recall: np.ndarray, precision: np.ndarray, interpolation: str = "11_points"
) -> float:
    if interpolation == "11_points":
        ap = 0.0
        for t in np.linspace(0.0, 1.0, 11):
            mask = recall >= t
            ap += (precision[mask].max() if mask.any() else 0.0) / 11.0
        return float(ap)
    if interpolation == "101_points":
        # pycocotools convention: precision envelope sampled at 101 recall
        # points (0:0.01:1), zero past the last achieved recall.
        mpre = precision.copy()
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        pts = np.linspace(0.0, 1.0, 101)
        idx = np.searchsorted(recall, pts, side="left")
        vals = np.zeros(101)
        ok = idx < len(mpre)
        vals[ok] = mpre[idx[ok]]
        return float(vals.mean())
    # All-point: area under the precision envelope.
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    changes = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[changes + 1] - mrec[changes]) * mpre[changes + 1]))


def _class_ap(
    scores: Sequence[float], tps: Sequence[bool], npos: int, interpolation: str
) -> float:
    """AP for one class from accumulated (score, tp) pairs. NaN if npos=0."""
    if npos == 0:
        return float("nan")
    s = np.asarray(scores)
    t = np.asarray(tps, bool)
    order = np.argsort(-s, kind="stable")
    t = t[order]
    tp_cum = np.cumsum(t)
    fp_cum = np.cumsum(~t)
    recall = tp_cum / npos
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1)
    return average_precision(recall, precision, interpolation)


def _normalize_flags(gt_boxes, gt_difficult, gt_crowd):
    g = len(gt_boxes)
    difficult = (np.zeros(g, bool) if gt_difficult is None
                 else np.asarray(gt_difficult, bool))
    crowd = (np.zeros(g, bool) if gt_crowd is None
             else np.asarray(gt_crowd, bool))
    return difficult, crowd


class DetectionEvaluator:
    def __init__(
        self,
        num_classes: int,
        iou_thresh: float = 0.5,
        interpolation: str = "11_points",
        class_names: Optional[Sequence[str]] = None,
        mode: str = "voc",
        area_range: Optional[tuple] = None,
        iou_type: str = "bbox",
    ):
        """``mode="voc"`` (default) is the reference parity protocol;
        ``mode="coco"`` follows pycocotools matching — see module docstring.
        ``area_range=(lo, hi)`` marks GT with box area outside the range as
        ignored (COCO's AP_small/medium/large) and, in COCO mode, ignores
        unmatched out-of-range detections instead of counting them as FPs.
        ``iou_type="segm"`` matches on MASK IoU (Mask R-CNN instance
        segmentation): ``add_image`` then requires ``pred_masks``/
        ``gt_masks`` box-frame crops, pasted once per image
        (data/masks.py) with intersections computed only over window
        overlaps — matching semantics are otherwise identical."""
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"iou_type must be 'bbox' or 'segm', got {iou_type!r}")
        self.num_classes = num_classes
        self.iou_thresh = iou_thresh
        self.interpolation = interpolation
        self.class_names = class_names
        self.mode = mode
        self.area_range = area_range
        self.iou_type = iou_type
        # Per class: score list, tp list (parallel), and positive-GT count.
        self._scores: List[List[float]] = [[] for _ in range(num_classes)]
        self._tps: List[List[bool]] = [[] for _ in range(num_classes)]
        self._npos = np.zeros(num_classes, np.int64)

    def add_image(
        self,
        pred_boxes: np.ndarray,     # [D, 4]
        pred_scores: np.ndarray,    # [D]
        pred_classes: np.ndarray,   # [D] in 1..C
        gt_boxes: np.ndarray,       # [G, 4]
        gt_classes: np.ndarray,     # [G] in 1..C
        gt_difficult: Optional[np.ndarray] = None,  # [G] bool
        gt_crowd: Optional[np.ndarray] = None,      # [G] bool (COCO iscrowd)
        pred_masks=None,   # [D, m, m] box-frame probs (iou_type="segm")
        gt_masks=None,     # [G, M, M] box-frame crops (iou_type="segm")
    ):
        difficult, crowd = _normalize_flags(gt_boxes, gt_difficult, gt_crowd)
        gt_ignore = difficult | crowd
        det_oor = np.zeros(len(pred_boxes), bool)
        pasted_d = pasted_g = None
        d_areas_all = _box_areas(pred_boxes)
        g_areas_all = _box_areas(gt_boxes)
        if self.iou_type == "segm":
            pasted_d, pasted_g, d_areas_all, g_areas_all = _paste_for_segm(
                pred_boxes, pred_masks, gt_boxes, gt_masks
            )
        if self.area_range is not None:
            lo, hi = self.area_range
            gt_ignore |= (g_areas_all < lo) | (g_areas_all >= hi)
            det_oor = (d_areas_all < lo) | (d_areas_all >= hi)
        for c in range(1, self.num_classes + 1):
            det_mask = pred_classes == c
            gt_mask = gt_classes == c
            if not det_mask.any() and not gt_mask.any():
                continue  # nothing to match or count for this class
            self._npos[c - 1] += int((~gt_ignore[gt_mask]).sum())

            d_scores = pred_scores[det_mask]
            order = np.argsort(-d_scores, kind="stable")
            d_boxes = pred_boxes[det_mask][order]
            d_scores = d_scores[order]
            d_oor = det_oor[det_mask][order]
            g_boxes = gt_boxes[gt_mask]
            g_ignore = gt_ignore[gt_mask]
            g_crowd = crowd[gt_mask]
            if self.iou_type == "segm":
                iou = (_segm_iou(pasted_d, pasted_g, det_mask, order,
                                 gt_mask, g_crowd)
                       if len(g_boxes) else None)
            else:
                iou = (_iou_matrix(d_boxes, g_boxes, g_crowd)
                       if len(g_boxes) else None)
            codes = _match_dets(
                iou, g_ignore, g_crowd, d_oor, self.iou_thresh, self.mode
            )
            keep = codes >= 0
            self._scores[c - 1].extend(d_scores[keep].tolist())
            self._tps[c - 1].extend((codes[keep] == 1).tolist())

    def summarize(self) -> Dict[str, float]:
        aps = {}
        for c in range(self.num_classes):
            name = (
                self.class_names[c] if self.class_names else f"class_{c + 1}"
            )
            aps[name] = _class_ap(
                self._scores[c], self._tps[c], self._npos[c],
                self.interpolation,
            )
        valid = [v for v in aps.values() if not np.isnan(v)]
        result = {f"AP/{k}": v for k, v in aps.items()}
        result["mAP"] = float(np.mean(valid)) if valid else 0.0
        return result

    def max_recalls(self) -> np.ndarray:
        """Per-class final recall (COCO AR@maxdets: recall achieved with all
        accumulated detections — callers cap detections per image upstream).
        NaN for classes with no positive GT."""
        out = np.full(self.num_classes, np.nan)
        for c in range(self.num_classes):
            if self._npos[c] > 0:
                out[c] = float(np.sum(self._tps[c])) / float(self._npos[c])
        return out


class CocoStyleEvaluator:
    """COCO-protocol evaluator (BASELINE configs 4–5 are COCO): AP averaged
    over IoU thresholds 0.50:0.05:0.95 with 101-point interpolation, the
    size-stratified APs (small/medium/large — pycocotools area breakpoints
    32² and 96², on box area), and AR@maxdets. Host-side NumPy — exactness
    over speed, same philosophy as the parity referee — but the per-image
    work is shared across the 40 (threshold × area-range) accumulation
    banks: the IoU matrix and score ordering are computed once per
    (image, class) and only the cheap greedy pass runs per bank."""

    THRESHOLDS = [0.5 + 0.05 * i for i in range(10)]
    AREA_RANGES = {
        "all": (0.0, 1e10),
        "small": (0.0, 32.0 ** 2),
        "medium": (32.0 ** 2, 96.0 ** 2),
        "large": (96.0 ** 2, 1e10),
    }

    def __init__(self, num_classes: int, class_names=None,
                 iou_type: str = "bbox", keypoint_sigmas=None):
        """``iou_type="segm"`` scores instance segmentation: matching runs
        on pasted-mask IoU, detection areas are mask pixel counts, and GT
        areas prefer the annotation's own 'area' field (exactly
        pycocotools' segm protocol).

        ``iou_type="keypoints"`` scores pose estimation: matching runs on
        OKS (``keypoint_sigmas`` required — the per-keypoint κ constants,
        COCO-17 person values in DataConfig.keypoint_sigmas); GT with zero
        labeled keypoints are ignore regions (the pycocotools rule, which
        also covers crowds — crowd annotations carry no keypoints); the
        area-range bins keep box/annotation areas."""
        if iou_type not in ("bbox", "segm", "keypoints"):
            raise ValueError(
                f"iou_type must be 'bbox', 'segm' or 'keypoints', "
                f"got {iou_type!r}")
        if iou_type == "keypoints" and not keypoint_sigmas:
            raise ValueError("iou_type='keypoints' needs keypoint_sigmas")
        self.keypoint_sigmas = (
            tuple(keypoint_sigmas) if keypoint_sigmas else None
        )
        self.num_classes = num_classes
        self.class_names = class_names
        self.iou_type = iou_type
        C = num_classes
        self._keys = [(t, a) for t in self.THRESHOLDS for a in self.AREA_RANGES]
        self._scores = {k: [[] for _ in range(C)] for k in self._keys}
        self._tps = {k: [[] for _ in range(C)] for k in self._keys}
        # npos depends only on the area range, not the IoU threshold.
        self._npos = {a: np.zeros(C, np.int64) for a in self.AREA_RANGES}

    def add_image(
        self,
        pred_boxes: np.ndarray,
        pred_scores: np.ndarray,
        pred_classes: np.ndarray,
        gt_boxes: np.ndarray,
        gt_classes: np.ndarray,
        gt_difficult: Optional[np.ndarray] = None,
        gt_crowd: Optional[np.ndarray] = None,
        gt_area: Optional[np.ndarray] = None,
        pred_masks=None,   # [D, m, m] box-frame probs (iou_type="segm")
        gt_masks=None,     # [G, M, M] box-frame crops (iou_type="segm")
        pred_keypoints=None,  # [D, K, 3] (x, y, score) ("keypoints")
        gt_keypoints=None,    # [G, K, 3] (x, y, v) ("keypoints")
    ):
        """``gt_area``: the annotation's own area field (COCO segmentation
        area) per GT, in the same coordinate space as the boxes; entries < 0
        (or ``None``) fall back to box area (bbox) / pasted-mask area
        (segm). pycocotools bins GT by ``ann['area']`` while detections use
        box area (bbox) or mask RLE area (segm) — using box area for GT too
        systematically shifts mAP_small/medium/large on real COCO
        (thin/diagonal objects have segment area << box area)."""
        difficult, crowd = _normalize_flags(gt_boxes, gt_difficult, gt_crowd)
        base_ignore = difficult | crowd
        pasted_d = pasted_g = None
        if self.iou_type == "segm":
            pasted_d, pasted_g, det_areas, gt_areas = _paste_for_segm(
                pred_boxes, pred_masks, gt_boxes, gt_masks
            )
        else:
            gt_areas = _box_areas(gt_boxes)
            det_areas = _box_areas(pred_boxes)
        if gt_area is not None:
            gt_area = np.asarray(gt_area, np.float64)
            gt_areas = np.where(gt_area >= 0, gt_area, gt_areas)
        if self.iou_type == "keypoints":
            if pred_keypoints is None or gt_keypoints is None:
                raise ValueError(
                    "iou_type='keypoints' needs pred_keypoints and "
                    "gt_keypoints in add_image"
                )
            gt_keypoints = np.asarray(gt_keypoints, np.float64)
            # pycocotools: GT without labeled keypoints are ignore regions
            # (this also covers crowds, which carry no keypoints).
            base_ignore = base_ignore | (
                (gt_keypoints[:, :, 2] > 0).sum(axis=1) == 0
            )
        for c in range(1, self.num_classes + 1):
            det_mask = pred_classes == c
            gt_mask = gt_classes == c
            if not det_mask.any() and not gt_mask.any():
                continue
            d_scores = pred_scores[det_mask]
            order = np.argsort(-d_scores, kind="stable")
            d_boxes = pred_boxes[det_mask][order]
            d_scores_sorted = d_scores[order].tolist()
            d_areas = det_areas[det_mask][order]
            g_boxes = gt_boxes[gt_mask]
            g_base_ignore = base_ignore[gt_mask]
            g_crowd = crowd[gt_mask]
            g_areas = gt_areas[gt_mask]
            if self.iou_type == "segm":
                iou = (_segm_iou(pasted_d, pasted_g, det_mask, order,
                                 gt_mask, g_crowd)
                       if len(g_boxes) else None)
            elif self.iou_type == "keypoints":
                iou = (_oks_matrix(pred_keypoints[det_mask][order],
                                   gt_keypoints[gt_mask], g_boxes,
                                   g_areas, self.keypoint_sigmas)
                       if len(g_boxes) else None)
            else:
                iou = (_iou_matrix(d_boxes, g_boxes, g_crowd)
                       if len(g_boxes) else None)
            for a, (lo, hi) in self.AREA_RANGES.items():
                g_ignore = g_base_ignore | (g_areas < lo) | (g_areas >= hi)
                d_oor = (d_areas < lo) | (d_areas >= hi)
                self._npos[a][c - 1] += int((~g_ignore).sum())
                for t in self.THRESHOLDS:
                    codes = _match_dets(
                        iou, g_ignore, g_crowd, d_oor, t, "coco"
                    )
                    keep = codes >= 0
                    sc = self._scores[(t, a)][c - 1]
                    tp = self._tps[(t, a)][c - 1]
                    for i in np.flatnonzero(keep):
                        sc.append(d_scores_sorted[i])
                        tp.append(bool(codes[i] == 1))

    def _bank_aps(self, t: float, a: str) -> np.ndarray:
        return np.asarray([
            _class_ap(self._scores[(t, a)][c], self._tps[(t, a)][c],
                      self._npos[a][c], "101_points")
            for c in range(self.num_classes)
        ])

    def _mean_ap(self, area: str) -> float:
        vals = []
        for t in self.THRESHOLDS:
            aps = self._bank_aps(t, area)
            ok = aps[~np.isnan(aps)]
            vals.append(float(ok.mean()) if len(ok) else 0.0)
        return float(np.mean(vals))

    def _mean_ar(self, area: str) -> float:
        npos = self._npos[area]
        recalls = np.stack([
            np.asarray([
                float(np.sum(self._tps[(t, area)][c])) / npos[c]
                if npos[c] > 0 else np.nan
                for c in range(self.num_classes)
            ])
            for t in self.THRESHOLDS
        ])
        # nanmean per class, but skip all-NaN classes (no GT in range at any
        # threshold) without tripping numpy's empty-slice warning.
        present = ~np.isnan(recalls)
        counts = present.sum(axis=0)
        sums = np.where(present, recalls, 0.0).sum(axis=0)
        per_class = sums[counts > 0] / counts[counts > 0]
        return float(per_class.mean()) if per_class.size else 0.0

    def summarize(self) -> Dict[str, float]:
        ap50 = self._bank_aps(0.5, "all")
        ap50_ok = ap50[~np.isnan(ap50)]
        ap75 = self._bank_aps(0.75, "all")
        ap75_ok = ap75[~np.isnan(ap75)]
        out = {
            "mAP": self._mean_ap("all"),  # the COCO headline
            "mAP@0.5": float(ap50_ok.mean()) if len(ap50_ok) else 0.0,
            "mAP@0.75": float(ap75_ok.mean()) if len(ap75_ok) else 0.0,
            "mAP_small": self._mean_ap("small"),
            "mAP_medium": self._mean_ap("medium"),
            "mAP_large": self._mean_ap("large"),
            "AR": self._mean_ar("all"),
            "AR_small": self._mean_ar("small"),
            "AR_medium": self._mean_ar("medium"),
            "AR_large": self._mean_ar("large"),
        }
        # Per-class APs at 0.5 for debugging parity.
        for c in range(self.num_classes):
            name = (self.class_names[c] if self.class_names
                    else f"class_{c + 1}")
            out[f"AP/{name}"] = float(ap50[c])
        return out


class ProposalRecallEvaluator:
    """RPN proposal-recall analysis (Faster R-CNN §4's recall-vs-IoU /
    recall-vs-#proposals tables): fraction of GT boxes covered by a top-k
    (by score) proposal at IoU >= t, class-agnostic, host-side NumPy like
    the mAP referee. Difficult/crowd GT are excluded from the denominator
    (they are ignore-regions in both VOC and COCO protocols, so "missing"
    them is not a miss)."""

    def __init__(self, iou_thresholds=(0.5, 0.7), topk=(100, 300, 1000)):
        self.iou_thresholds = tuple(iou_thresholds)
        self.topk = tuple(sorted(topk))
        self._n_gt = 0
        self._n_images = 0
        self._n_proposals = 0
        self._hits = {(k, t): 0 for k in self.topk
                      for t in self.iou_thresholds}

    def add_image(self, boxes, scores, classes=None, gt_boxes=None,
                  gt_classes=None, gt_difficult=None, gt_crowd=None, **_):
        """Signature-compatible with the mAP evaluators (drop-in for the
        eval CLI's accumulation loop); classes are ignored — proposals are
        class-agnostic."""
        del classes, gt_classes
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64).reshape(-1)
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        keep = np.ones(len(gt_boxes), bool)
        if gt_difficult is not None:
            keep &= ~np.asarray(gt_difficult, bool)
        if gt_crowd is not None:
            keep &= ~np.asarray(gt_crowd, bool)
        gt_boxes = gt_boxes[keep]
        self._n_images += 1
        self._n_proposals += len(boxes)
        self._n_gt += len(gt_boxes)
        if not len(gt_boxes):
            return
        order = np.argsort(-scores, kind="stable")
        boxes = boxes[order]
        iou = _iou_matrix(boxes, gt_boxes) if len(boxes) else np.zeros(
            (0, len(gt_boxes))
        )
        for k in self.topk:
            sub = iou[:k]
            best = sub.max(axis=0) if len(sub) else np.zeros(len(gt_boxes))
            for t in self.iou_thresholds:
                self._hits[(k, t)] += int((best >= t).sum())

    def summarize(self) -> Dict[str, float]:
        out = {}
        denom = max(self._n_gt, 1)
        for k in self.topk:
            for t in self.iou_thresholds:
                out[f"recall@{k}_iou{t:g}"] = self._hits[(k, t)] / denom
        out["num_gt"] = float(self._n_gt)
        out["avg_proposals_per_image"] = (
            self._n_proposals / max(self._n_images, 1)
        )
        return out
