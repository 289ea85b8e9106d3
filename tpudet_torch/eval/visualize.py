"""Detection visualization (``tpudet.eval.visualize``, a copy): draw
predicted or ground-truth boxes and labels on images, on the host with PIL
(imported on first use)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_PALETTE = [
    (230, 60, 60), (60, 200, 90), (70, 110, 240), (240, 200, 60),
    (200, 80, 220), (80, 210, 220), (250, 150, 50), (150, 100, 60),
]


def draw_detections(
    image: np.ndarray,
    boxes: np.ndarray,
    classes: np.ndarray,
    scores: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    color_by_class: bool = True,
    masks: Optional[np.ndarray] = None,
    keypoints: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[h,w,3] uint8 + [N,4]/[N] -> annotated uint8 image.

    ``masks`` (optional, [N, m, m] box-frame probabilities — the Mask R-CNN
    predict output) overlays each instance's pasted mask as a translucent
    class-colored fill under the box outlines. ``keypoints`` (optional,
    [N, K, 3] (x, y, score) image coords — the Keypoint R-CNN output)
    draws each instance's keypoints as class-colored dots."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(image.astype(np.uint8)).convert("RGB")
    if masks is not None and len(boxes):
        from tpudet_torch.data.masks import paste_mask

        overlay = np.asarray(img).astype(np.float32)
        h, w = overlay.shape[:2]
        for i in range(len(boxes)):
            c = int(classes[i])
            color = np.asarray(
                _PALETTE[(c - 1) % len(_PALETTE)] if color_by_class
                else (255, 40, 40), np.float32,
            )
            y0, x0, bm = paste_mask(masks[i], boxes[i])
            # Clip the pasted window to the image.
            ys, xs = max(y0, 0), max(x0, 0)
            ye = min(y0 + bm.shape[0], h)
            xe = min(x0 + bm.shape[1], w)
            if ye <= ys or xe <= xs:
                continue
            sub = bm[ys - y0 : ye - y0, xs - x0 : xe - x0]
            region = overlay[ys:ye, xs:xe]
            region[sub] = 0.5 * region[sub] + 0.5 * color
        img = Image.fromarray(overlay.astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for i in range(len(boxes)):
        c = int(classes[i])
        color = _PALETTE[(c - 1) % len(_PALETTE)] if color_by_class else (255, 40, 40)
        x1, y1, x2, y2 = [float(v) for v in boxes[i]]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        label = (
            class_names[c - 1]
            if class_names and 0 < c <= len(class_names)
            else str(c)
        )
        if scores is not None:
            label = f"{label} {float(scores[i]):.2f}"
        tx, ty = x1 + 2, max(y1 - 12, 0)
        draw.text((tx, ty), label, fill=color)
        if keypoints is not None:
            for kx, ky, _ in keypoints[i]:
                draw.ellipse(
                    [float(kx) - 2, float(ky) - 2,
                     float(kx) + 2, float(ky) + 2],
                    fill=color, outline=(255, 255, 255),
                )
    return np.asarray(img)
