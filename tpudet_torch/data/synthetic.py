"""Synthetic detection dataset (``tpudet.data.synthetic``, a copy: numpy
only, bit-identical examples for every (seed, index)): coloured rectangles
on textured noise, class = colour bin. Deterministic per (seed, index), so
train and eval runs repeat and a model can learn the mapping with no
dataset on disk."""

from __future__ import annotations

from typing import Dict

import numpy as np

# Distinct base colors; class c uses _COLORS[(c - 1) % len].
_COLORS = np.asarray(
    [
        [220, 40, 40],
        [40, 200, 60],
        [50, 80, 230],
        [230, 210, 50],
        [200, 60, 200],
        [60, 210, 210],
        [240, 140, 40],
        [140, 90, 50],
    ],
    np.uint8,
)


class SyntheticDataset:
    def __init__(
        self,
        num_classes: int = 3,
        num_examples: int = 512,
        image_size: int = 256,
        max_objects: int = 4,
        seed: int = 0,
        with_masks: bool = False,
        with_keypoints: bool = False,
        num_keypoints: int = 5,
        with_semantic: bool = False,
        num_stuff_classes: int = 1,
    ):
        """``with_masks`` draws objects as filled ELLIPSES inscribed in their
        boxes (instead of full rectangles) and emits per-instance full-image
        binary masks — so the instance-segmentation branch has pixel-accurate
        GT that genuinely differs from the box fill (a mask head that just
        predicts the box scores ~(pi/4)² IoU against an ellipse). The rng
        draw order is identical to the rectangle mode, so boxes/classes per
        (seed, index) are unchanged."""
        self.num_classes = num_classes
        self.num_examples = num_examples
        self.image_size = image_size
        self.max_objects = max_objects
        self.seed = seed
        self.with_masks = with_masks
        # 5 keypoints per object, derived from its box: center, LEFT edge
        # midpoint, RIGHT edge midpoint, top midpoint, bottom midpoint —
        # all visible (v=2). (1, 2) is the horizontal-flip swap pair. The
        # rng draw order is unchanged, so boxes/classes per (seed, index)
        # are identical to the other modes; a visual cue (bright corner dot
        # at the object center) makes the center keypoint learnable.
        self.with_keypoints = with_keypoints
        # Emitted keypoint count: the 5 geometric points first, any extra
        # slots unlabeled (v=0) — lets configs with a different
        # data.num_keypoints (e.g. the COCO-17 presets) run on synthetic
        # data for benchmarks/smoke without shape mismatches.
        self.num_keypoints = num_keypoints
        # Panoptic GT: a [h, w] uint8 class map — stuff class 1 everywhere
        # (synthetic has one background stuff class), each object drawn on
        # top as num_stuff_classes + its thing class, in draw order (later
        # objects occlude). Ellipse-shaped when with_masks, box-filled
        # otherwise — matching the rendered pixels exactly.
        self.with_semantic = with_semantic
        self.num_stuff_classes = num_stuff_classes

    def __len__(self) -> int:
        return self.num_examples

    def example_hw(self, index: int) -> tuple:
        """Original (h, w) without materializing the image (loader bucketing)."""
        return self.image_size, self.image_size

    def get_example(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) + index)
        s = self.image_size
        image = rng.integers(90, 130, (s, s, 3)).astype(np.uint8)

        n = int(rng.integers(1, self.max_objects + 1))
        boxes, classes, masks = [], [], []
        semantic = (np.ones((s, s), np.uint8) if self.with_semantic
                    else None)
        for _ in range(n):
            w = int(rng.integers(s // 8, s // 2))
            h = int(rng.integers(s // 8, s // 2))
            x1 = int(rng.integers(0, s - w))
            y1 = int(rng.integers(0, s - h))
            c = int(rng.integers(1, self.num_classes + 1))
            color = _COLORS[(c - 1) % len(_COLORS)]
            jitter = rng.integers(-15, 16, 3)
            fill = np.clip(color.astype(int) + jitter, 0, 255).astype(np.uint8)
            if self.with_masks:
                # Filled ellipse inscribed in the box (pixel-center test).
                yy, xx = np.mgrid[y1 : y1 + h, x1 : x1 + w]
                cy, cx = y1 + h / 2.0, x1 + w / 2.0
                inside = (
                    ((xx + 0.5 - cx) / (w / 2.0)) ** 2
                    + ((yy + 0.5 - cy) / (h / 2.0)) ** 2
                ) <= 1.0
                region = image[y1 : y1 + h, x1 : x1 + w]
                region[inside] = fill
                mask = np.zeros((s, s), np.uint8)
                mask[y1 : y1 + h, x1 : x1 + w] = inside
                masks.append(mask)
                if semantic is not None:
                    sem_region = semantic[y1 : y1 + h, x1 : x1 + w]
                    sem_region[inside] = self.num_stuff_classes + c
            else:
                image[y1 : y1 + h, x1 : x1 + w] = fill
                if semantic is not None:
                    semantic[y1 : y1 + h, x1 : x1 + w] = (
                        self.num_stuff_classes + c
                    )
            if self.with_keypoints:
                # Bright marker at the object center so the keypoint is a
                # visual feature, not just box geometry.
                cy_i, cx_i = y1 + h // 2, x1 + w // 2
                image[max(cy_i - 1, 0): cy_i + 2,
                      max(cx_i - 1, 0): cx_i + 2] = 255
            boxes.append([x1, y1, x1 + w, y1 + h])
            classes.append(c)

        out = {
            "image": image,
            "boxes": np.asarray(boxes, np.float32),
            "classes": np.asarray(classes, np.int32),
        }
        if self.with_masks:
            out["masks"] = masks
        if semantic is not None:
            out["semantic"] = semantic
        if self.with_keypoints:
            kk = self.num_keypoints
            kps = np.zeros((len(out["boxes"]), kk, 3), np.float32)
            for i, (x1, y1, x2, y2) in enumerate(out["boxes"]):
                cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
                pts = [
                    [cx, cy, 2.0],
                    [x1, cy, 2.0],   # left-mid  (flip pair with right-mid)
                    [x2, cy, 2.0],   # right-mid
                    [cx, y1, 2.0],   # top-mid
                    [cx, y2, 2.0],   # bottom-mid
                ][:kk]
                kps[i, : len(pts)] = pts
            out["keypoints"] = kps
        return out
