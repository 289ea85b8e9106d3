"""Box-frame instance masks (``tpudet.data.masks``, a copy: numpy and PIL).

Every ground-truth instance mask is rasterized once, on the host, into the
frame of its own box at a fixed ``gt_mask_size`` (M x M uint8), so the
loader ships ~12 KB per instance at M = 112 instead of a full-canvas mask.
Training resamples a crop into each matched RoI's frame on the device
(``tpudet_torch.ops.masks``).

Coordinate convention (shared with ``ops.masks`` and the evaluator's
paste): crop pixel (i, j)'s centre sits at ``y1 + (i + 0.5) * box_h / M``,
``x1 + (j + 0.5) * box_w / M`` in image coordinates, so the crop covers the
box's extent exactly and an image resize never touches it (only the box
scales).

The ``masks`` of a dataset example hold one entry per instance:

* ``np.ndarray`` [h, w]: a full-image binary mask (the synthetic dataset);
* a ``dict``: COCO RLE, uncompressed (list counts) or compressed (string);
* a ``list`` of flat [x0, y0, x1, y1, ...] polygons (COCO), rasterized
  straight into the M x M box frame with PIL's ``ImageDraw``;
* ``None``: an instance without a mask; its crop stays zero.

The RLE codec is pycocotools' layout (column-major runs; the compressed
string's 5-bit varints, delta-coded from the third count), written from its
spec, so the results JSON needs no pycocotools.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

MaskRep = Union[np.ndarray, list, None]


def rle_counts_from_string(s: str) -> List[int]:
    """Decode pycocotools' compressed RLE ``counts`` string.

    Format (pycocotools rleFrString): a sequence of signed varints, 5 value
    bits per char (chars offset by 48), bit 0x20 = continuation; a terminal
    chunk with bit 0x10 sign-extends. From the third count on, each value is
    delta-coded against the count two positions back (runs of the same
    parity)."""
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_decode(rle: dict) -> np.ndarray:
    """COCO RLE dict -> full-image uint8 mask [h, w].

    ``counts`` may be a list (uncompressed) or string (compressed); runs
    alternate background/foreground in COLUMN-major order per the COCO
    spec."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = rle_counts_from_string(counts)
    elif isinstance(counts, bytes):
        counts = rle_counts_from_string(counts.decode("ascii"))
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in counts:
        if val:
            flat[pos : pos + run] = 1
        pos += run
        val ^= 1
    if pos != h * w:
        raise ValueError(
            f"RLE runs cover {pos} pixels, mask is {h}x{w}={h * w}"
        )
    return flat.reshape(w, h).T  # column-major -> [h, w]


def rle_string_from_counts(counts: Sequence[int]) -> str:
    """Encode run counts as pycocotools' compressed string (the exact
    inverse of ``rle_counts_from_string``): delta-code each count from the
    third on against the count two back, then emit signed 5-bit varints
    offset by 48 with 0x20 continuation."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x = x - counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def rle_encode(mask: np.ndarray) -> dict:
    """Full-image binary mask [h, w] -> COCO compressed RLE dict
    (column-major runs + string counts), the results-json segmentation
    format pycocotools' ``COCOeval`` consumes directly."""
    m = np.asarray(mask) > 0
    h, w = m.shape
    flat = m.T.reshape(-1)  # column-major per the COCO spec
    # Run boundaries, with a leading background run (possibly length 0).
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    elif not flat.size:
        counts = []
    return {"size": [int(h), int(w)], "counts": rle_string_from_counts(counts)}


def mask_to_rle(
    mask: np.ndarray, box: Sequence[float], image_hw: Sequence[int],
    threshold: float = 0.5,
) -> dict:
    """Box-frame mask probabilities -> full-image COCO RLE: paste onto the
    image grid (clipped) and run-length encode."""
    h, w = int(image_hw[0]), int(image_hw[1])
    full = np.zeros((h, w), bool)
    y0, x0, bm = paste_mask(mask, box, threshold)
    ys, xs = max(y0, 0), max(x0, 0)
    ye, xe = min(y0 + bm.shape[0], h), min(x0 + bm.shape[1], w)
    if ye > ys and xe > xs:
        full[ys:ye, xs:xe] = bm[ys - y0 : ye - y0, xs - x0 : xe - x0]
    return rle_encode(full)


def crop_from_full(mask: np.ndarray, box: Sequence[float], m: int) -> np.ndarray:
    """Resample a full-image binary mask into its box frame: [m, m] uint8.

    Uses PIL's region-resize (``box=`` takes float edges in the continuous
    pixel space where pixel i spans [i, i+1]) — the same extent-covering
    convention as the device resampler — then binarizes at 0.5."""
    from PIL import Image

    x1, y1, x2, y2 = (float(v) for v in box)
    if x2 <= x1 or y2 <= y1:
        return np.zeros((m, m), np.uint8)
    img = Image.fromarray((np.asarray(mask) > 0).astype(np.uint8) * 255)
    crop = img.resize((m, m), Image.BILINEAR, box=(x1, y1, x2, y2))
    return (np.asarray(crop) >= 128).astype(np.uint8)


def crop_from_polys(
    polys: Sequence[Sequence[float]], box: Sequence[float], m: int
) -> np.ndarray:
    """Rasterize COCO polygons straight into the box frame: [m, m] uint8.

    Each polygon is a flat [x0, y0, x1, y1, ...] list in image coordinates;
    points map affinely into the m x m crop (pixel-center convention) and
    multiple polygons union. Rasterizing in the crop frame sidesteps the
    O(image area) full-resolution raster entirely."""
    from PIL import Image, ImageDraw

    x1, y1, x2, y2 = (float(v) for v in box)
    w, h = max(x2 - x1, 1e-4), max(y2 - y1, 1e-4)
    img = Image.new("L", (m, m), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        # Image coords -> crop pixel coords: pixel (i, j) center at
        # x1 + (j + 0.5) * w / m, so x maps to (x - x1) * m / w - 0.5.
        u = (pts[:, 0] - x1) * m / w - 0.5
        v = (pts[:, 1] - y1) * m / h - 0.5
        draw.polygon(list(zip(u.tolist(), v.tolist())), fill=1)
    return np.asarray(img, np.uint8)


def crop_instance(rep: MaskRep, box: Sequence[float], m: int) -> np.ndarray:
    """One instance's mask rep (see module docstring) -> [m, m] uint8 crop."""
    if rep is None:
        return np.zeros((m, m), np.uint8)
    if isinstance(rep, np.ndarray):
        return crop_from_full(rep, box, m)
    if isinstance(rep, dict):  # raw COCO RLE
        return crop_from_full(rle_decode(rep), box, m)
    return crop_from_polys(rep, box, m)


def crop_instances(
    reps: Optional[Sequence[MaskRep]],
    boxes: np.ndarray,
    m: int,
) -> np.ndarray:
    """All instances of one example -> [n, m, m] uint8 box-frame crops."""
    n = len(boxes)
    out = np.zeros((n, m, m), np.uint8)
    if reps is None:
        return out
    for i in range(min(n, len(reps))):
        out[i] = crop_instance(reps[i], boxes[i], m)
    return out


def mask_iou_matrix(
    d_boxes: np.ndarray,
    d_masks: Sequence[np.ndarray],
    g_boxes: np.ndarray,
    g_masks: Sequence[np.ndarray],
    g_crowd: Optional[np.ndarray] = None,
    threshold: float = 0.5,
) -> np.ndarray:
    """Pairwise mask IoU [D, G] between box-frame masks, via paste.

    Both sides are box-frame crops (detections: predicted probabilities at
    the head resolution; GT: the loader's uint8 crops); each is pasted once
    onto its box's integer pixel grid (``paste_mask``) and the pairwise
    intersection is computed only over the overlap of the two pasted
    windows — never at O(image area). Crowd GT columns use the pycocotools
    convention: intersection over the DETECTION's area. Same contract as
    ``eval.metrics._iou_matrix`` for boxes."""
    pd = [paste_mask(m, b, threshold) for m, b in zip(d_masks, d_boxes)]
    pg = [paste_mask(m, b, threshold) for m, b in zip(g_masks, g_boxes)]
    return pasted_iou_matrix(pd, pg, g_crowd)


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
