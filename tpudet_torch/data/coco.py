"""COCO 2017 ingestion (``tpudet.data.coco``, a copy): boxes, crowd, area,
the category map, the instance masks (polygons or RLE, for Mask R-CNN) and
the keypoints (for Keypoint R-CNN).

Reads ``annotations/instances_{split}2017.json`` (``person_keypoints_`` with
``data.load_keypoints``) + ``{split}2017/`` images.
Category ids are remapped to contiguous 1..C (COCO's 80 categories have
non-contiguous ids); boxes convert from [x, y, w, h] to [x1, y1, x2, y2].
Pure-Python JSON parsing — no pycocotools dependency."""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np


class CocoDataset:
    def __init__(self, root: str, split: str = "train",
                 min_box_size: float = 1.0, keep_crowd: bool = False,
                 ann_prefix: str = "instances"):
        """``keep_crowd`` carries iscrowd annotations through as ignore
        regions (emitted with ``difficult``/``crowd`` flags set) — required
        for protocol-faithful evaluation, where detections matched to a
        crowd are ignored rather than counted as false positives. Training
        splits drop them (crowd regions are not usable as box targets).

        ``ann_prefix`` picks the annotation file:
        ``annotations/{ann_prefix}_{split}2017.json``. The 'keypoints'
        fields live ONLY in ``person_keypoints_*.json`` (a 1-category
        person-only file) — the instances files carry none, so keypoint
        training against them would silently see zero supervision;
        ``build_dataset`` selects the prefix from ``data.load_keypoints``."""
        splits = {"train": "train2017", "val": "val2017",
                  "train2017": "train2017", "val2017": "val2017"}
        if split not in splits:
            raise ValueError(
                f"unknown COCO split {split!r} (valid: {sorted(splits)}; "
                "test2017 has no public instance annotations)"
            )
        name = splits[split]
        self.is_train = name.startswith("train")
        ann_path = os.path.join(
            root, "annotations", f"{ann_prefix}_{name}.json"
        )
        with open(ann_path) as f:
            blob = json.load(f)

        cats = sorted(blob["categories"], key=lambda c: c["id"])
        self.cat_id_to_class = {c["id"]: i + 1 for i, c in enumerate(cats)}
        self.class_names = tuple(c["name"] for c in cats)
        self.num_classes = len(cats)

        self.image_dir = os.path.join(root, name)
        images = {im["id"]: im for im in blob["images"]}
        anns_by_image: Dict[int, List[dict]] = {}
        for ann in blob["annotations"]:
            if ann.get("iscrowd", 0) and not keep_crowd:
                continue
            w, h = ann["bbox"][2], ann["bbox"][3]
            # Degenerate-box filter is TRAINING-only: pycocotools keeps all
            # GT in npos, so dropping them on eval splits would inflate AP
            # relative to the protocol.
            if self.is_train and (w < min_box_size or h < min_box_size):
                continue
            anns_by_image.setdefault(ann["image_id"], []).append(ann)

        # Keep only images that exist with at least one usable annotation
        # for training; keep all images for val.
        self.examples = []
        for img_id, im in sorted(images.items()):
            anns = anns_by_image.get(img_id, [])
            if name.startswith("train") and not anns:
                continue
            self.examples.append((im, anns))

    def __len__(self) -> int:
        return len(self.examples)

    def image_id(self, index: int):
        """COCO image id of dataset record ``index`` (for results export)."""
        return self.examples[index][0]["id"]

    def category_id(self, cls: int) -> int:
        """Contiguous class index (1..C) -> original COCO category id."""
        if not hasattr(self, "_class_to_cat_id"):
            self._class_to_cat_id = {
                v: k for k, v in self.cat_id_to_class.items()
            }
        return self._class_to_cat_id[int(cls)]

    def example_hw(self, index: int) -> tuple:
        """Original (h, w) from the annotation index — no image decode."""
        im, _ = self.examples[index]
        return im["height"], im["width"]

    def _annotations(self, anns):
        boxes, classes, crowd, areas, masks = [], [], [], [], []
        keypoints = []
        for ann in anns:
            x, y, w, h = ann["bbox"]
            boxes.append([x, y, x + w, y + h])
            classes.append(self.cat_id_to_class[ann["category_id"]])
            crowd.append(bool(ann.get("iscrowd", 0)))
            # pycocotools bins GT by the annotation's own 'area' field (the
            # segmentation area, usually < box area for thin/diagonal
            # objects) — carry it through for protocol-exact size-stratified
            # metrics. Box area is the fallback for malformed annotations.
            areas.append(float(ann.get("area", w * h)))
            # Instance mask rep (Mask R-CNN branch): polygon list or RLE
            # dict, consumed lazily by data/masks.py only when
            # cfg.data.load_masks — carrying the raw rep costs nothing
            # (it's already parsed in the annotation blob).
            masks.append(ann.get("segmentation") or None)
            # COCO keypoints: flat [x1, y1, v1, ...] per instance (person
            # category). Consumed only when cfg.data.load_keypoints; None
            # for instances without the field.
            kp = ann.get("keypoints")
            keypoints.append(
                np.asarray(kp, np.float32).reshape(-1, 3)
                if kp else None
            )
        return (
            np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(classes, np.int32),
            np.asarray(crowd, bool),
            np.asarray(areas, np.float32),
            masks,
            keypoints,
        )

    def get_example(self, index: int) -> Dict[str, np.ndarray]:
        from tpudet_torch.data.voc import _pil_image

        im, anns = self.examples[index]
        path = os.path.join(self.image_dir, im["file_name"])
        img = _pil_image(path).open(path).convert("RGB")
        boxes, classes, crowd, areas, masks, keypoints = \
            self._annotations(anns)
        return {
            "image": np.asarray(img, np.uint8),
            "boxes": boxes,
            "classes": classes,
            # Crowd GT are ignore regions for the evaluator: neither counted
            # as positives nor penalizing overlapping detections.
            "difficult": crowd,
            "crowd": crowd,
            "area": areas,
            "masks": masks,
            "keypoints": keypoints,
            "id": im["id"],
        }

    def get_raw(self, index: int) -> Dict[str, np.ndarray]:
        """``get_example`` with the JPEG's bytes in place of the pixels
        (COCO's images are JPEGs), for the native front end."""
        im, anns = self.examples[index]
        with open(os.path.join(self.image_dir, im["file_name"]), "rb") as f:
            jpeg = f.read()
        boxes, classes, crowd, areas, masks, keypoints = \
            self._annotations(anns)
        return {"jpeg": jpeg, "boxes": boxes, "classes": classes,
                "difficult": crowd, "crowd": crowd, "area": areas,
                "masks": masks, "keypoints": keypoints, "id": im["id"]}
