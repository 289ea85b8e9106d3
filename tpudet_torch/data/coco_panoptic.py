"""COCO panoptic ingestion (Panoptic FPN; annotation format of
arXiv:1801.00868 §5 / the panopticapi): ``annotations/panoptic_{split}2017
.json`` + the PNG id maps under ``annotations/panoptic_{split}2017/``.

Each PNG pixel encodes a segment id as R + 256·G + 65536·B (0 = void); the
json's ``segments_info`` gives each segment's category/box/area. Thing
segments become detection GT (boxes/classes/crowd/full-image binary masks);
stuff segments and the thing pixels together form the ORIGINAL-resolution
semantic class map the loader downsamples to the branch's 1/4 scale
(``tpudet.data.coco_panoptic``, a copy).

Contiguous label spaces: thing categories (isthing=1, sorted by id) ->
detection classes 1..C; stuff categories -> 1..S; semantic labels are
stuff as-is and things shifted to S + class; 0 stays void. Pure-Python
JSON + PNG (PIL) — no panopticapi dependency."""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np


class CocoPanopticDataset:
    def __init__(self, root: str, split: str = "train",
                 keep_crowd: bool = False):
        splits = {"train": "train2017", "val": "val2017",
                  "train2017": "train2017", "val2017": "val2017"}
        if split not in splits:
            raise ValueError(
                f"unknown COCO split {split!r} (valid: {sorted(splits)})"
            )
        name = splits[split]
        self.is_train = name.startswith("train")
        self.keep_crowd = keep_crowd
        ann_path = os.path.join(
            root, "annotations", f"panoptic_{name}.json"
        )
        with open(ann_path) as f:
            blob = json.load(f)
        self.png_dir = os.path.join(root, "annotations", f"panoptic_{name}")
        self.image_dir = os.path.join(root, name)

        things = sorted(
            (c for c in blob["categories"] if c.get("isthing", 1)),
            key=lambda c: c["id"],
        )
        stuff = sorted(
            (c for c in blob["categories"] if not c.get("isthing", 1)),
            key=lambda c: c["id"],
        )
        self.cat_id_to_class = {c["id"]: i + 1 for i, c in enumerate(things)}
        self.cat_id_to_stuff = {c["id"]: i + 1 for i, c in enumerate(stuff)}
        self.class_names = tuple(c["name"] for c in things)
        self.stuff_names = tuple(c["name"] for c in stuff)
        self.num_classes = len(things)
        self.num_stuff_classes = len(stuff)

        images = {im["id"]: im for im in blob["images"]}
        anns = {a["image_id"]: a for a in blob["annotations"]}
        self.examples = []
        for img_id in sorted(images):
            if img_id not in anns:
                continue
            self.examples.append((images[img_id], anns[img_id]))

    def __len__(self) -> int:
        return len(self.examples)

    def image_id(self, index: int):
        return self.examples[index][0]["id"]

    def category_id(self, cls: int) -> int:
        if not hasattr(self, "_class_to_cat_id"):
            self._class_to_cat_id = {
                v: k for k, v in self.cat_id_to_class.items()
            }
        return self._class_to_cat_id[int(cls)]

    def example_hw(self, index: int) -> tuple:
        im, _ = self.examples[index]
        return im["height"], im["width"]

    def _decode_ids(self, png_name: str) -> np.ndarray:
        from PIL import Image

        rgb = np.asarray(
            Image.open(os.path.join(self.png_dir, png_name)).convert("RGB"),
            np.uint32,
        )
        return rgb[..., 0] + 256 * rgb[..., 1] + 65536 * rgb[..., 2]

    def get_example(self, index: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        im, ann = self.examples[index]
        img = Image.open(
            os.path.join(self.image_dir, im["file_name"])
        ).convert("RGB")
        ids = self._decode_ids(ann["file_name"])
        s = self.num_stuff_classes
        semantic = np.zeros(ids.shape, np.uint8)  # 0 = void
        boxes: List[List[float]] = []
        classes: List[int] = []
        crowd: List[bool] = []
        areas: List[float] = []
        masks: List[np.ndarray] = []
        for seg in ann["segments_info"]:
            region = ids == seg["id"]
            if seg["category_id"] in self.cat_id_to_stuff:
                semantic[region] = self.cat_id_to_stuff[seg["category_id"]]
                continue
            cls = self.cat_id_to_class[seg["category_id"]]
            semantic[region] = s + cls
            is_crowd = bool(seg.get("iscrowd", 0))
            if is_crowd and not self.keep_crowd:
                continue
            x, y, w, h = seg["bbox"]
            boxes.append([x, y, x + w, y + h])
            classes.append(cls)
            crowd.append(is_crowd)
            areas.append(float(seg.get("area", w * h)))
            masks.append(region.astype(np.uint8))
        crowd_arr = np.asarray(crowd, bool)
        return {
            "image": np.asarray(img, np.uint8),
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int32),
            "difficult": crowd_arr,
            "crowd": crowd_arr,
            "area": np.asarray(areas, np.float32),
            "masks": masks,
            "semantic": semantic,
            "id": im["id"],
        }
