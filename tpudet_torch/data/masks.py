"""Box-frame instance masks pasted onto the pixel grid (the part of
``tpudet.data.masks`` that the segm evaluator and the visualizer read; the
loader's mask crops come with Mask R-CNN)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def pasted_area(pasted: tuple) -> float:
    """Pixel area of a ``paste_mask`` result."""
    return float(pasted[2].sum())


def pasted_iou_matrix(
    pd: Sequence[tuple],
    pg: Sequence[tuple],
    g_crowd: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Pairwise IoU between pre-pasted masks (``paste_mask`` outputs) —
    callers paste once per image and reuse across per-class subsets."""
    out = np.zeros((len(pd), len(pg)), np.float64)
    d_areas = [pasted_area(p) for p in pd]
    g_areas = [pasted_area(p) for p in pg]
    for i, (dy, dx, dm) in enumerate(pd):
        dh, dw = dm.shape
        for j, (gy, gx, gm) in enumerate(pg):
            gh, gw = gm.shape
            y0, y1 = max(dy, gy), min(dy + dh, gy + gh)
            x0, x1 = max(dx, gx), min(dx + dw, gx + gw)
            if y1 <= y0 or x1 <= x0:
                continue
            inter = float(np.logical_and(
                dm[y0 - dy : y1 - dy, x0 - dx : x1 - dx],
                gm[y0 - gy : y1 - gy, x0 - gx : x1 - gx],
            ).sum())
            if g_crowd is not None and g_crowd[j]:
                union = d_areas[i]
            else:
                union = d_areas[i] + g_areas[j] - inter
            if union > 0:
                out[i, j] = inter / union
    return out


def paste_mask(
    mask: np.ndarray, box: Sequence[float], threshold: float = 0.5
) -> tuple:
    """Paste a box-frame mask (crop or predicted probabilities) onto the
    integer pixel grid covering its box: returns ``(y0, x0, binary [h, w])``.

    Pixel (y0 + i, x0 + j)'s center is sampled bilinearly from the crop
    under the shared extent-covering convention; everything outside the box
    is zero (so IoU only needs the box-intersection region). Host-side
    NumPy — used by the segm evaluator and visualization."""
    x1, y1, x2, y2 = (float(v) for v in box)
    x0, y0 = int(np.floor(x1)), int(np.floor(y1))
    x1c, y1c = int(np.ceil(x2)), int(np.ceil(y2))
    w, h = max(x1c - x0, 0), max(y1c - y0, 0)
    if w == 0 or h == 0:
        return y0, x0, np.zeros((h, w), bool)
    m_h, m_w = mask.shape
    # Pixel centers in crop coordinates.
    ys = (np.arange(h) + y0 + 0.5 - y1) * m_h / max(y2 - y1, 1e-4) - 0.5
    xs = (np.arange(w) + x0 + 0.5 - x1) * m_w / max(x2 - x1, 1e-4) - 0.5
    wv = np.maximum(0.0, 1.0 - np.abs(ys[:, None] - np.arange(m_h)[None, :]))
    wu = np.maximum(0.0, 1.0 - np.abs(xs[:, None] - np.arange(m_w)[None, :]))
    vals = wv @ np.asarray(mask, np.float32) @ wu.T
    return y0, x0, vals > threshold
