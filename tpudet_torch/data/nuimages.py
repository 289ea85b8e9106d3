"""nuImages (nuScenes-style) ingestion (``tpudet.data.nuimages``, a copy):
the autonomous-driving image set, with the Dataset interface of VOC and
COCO.

nuImages v1.0 is relational JSON, one table per file under
``{root}/{version}/``:

* ``category.json``      — {token, name, ...}
* ``sample_data.json``   — {token, filename, width, height, is_key_frame, ...}
* ``object_ann.json``    — {sample_data_token, category_token,
  bbox [x1, y1, x2, y2], ...}

Images live at ``{root}/{filename}`` (e.g. ``samples/CAM_FRONT/...jpg``).
2D object annotations exist only for key frames, so non-key-frame
``sample_data`` rows are skipped. Class ids are the category table sorted by
name → contiguous 1..C (deterministic; independent of which categories happen
to be annotated). nuImages has no crowd/difficult concept — those flags are
all-False — and ``object_ann`` carries no precomputed area, so size-stratified
eval bins by box area (the -1 sentinel convention of ``eval/metrics.py``
applies: we emit box area directly).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from tpudet_torch.data.voc import _pil_image


class NuImagesDataset:
    def __init__(self, root: str, split: str = "train",
                 min_box_size: float = 1.0):
        splits = {"train": "v1.0-train", "val": "v1.0-val",
                  "test": "v1.0-test", "mini": "v1.0-mini"}
        version = splits.get(split, split)
        table_dir = os.path.join(root, version)
        if not os.path.isdir(table_dir):
            raise FileNotFoundError(
                f"nuImages table dir not found: {table_dir} (root must hold "
                f"a v1.0-* version dir; got split={split!r})"
            )

        def table(name: str) -> List[dict]:
            with open(os.path.join(table_dir, name + ".json")) as f:
                return json.load(f)

        self.root = root
        self.is_train = version.endswith("train") or version.endswith("mini")

        cats = sorted(table("category"), key=lambda c: c["name"])
        self.cat_token_to_class = {c["token"]: i + 1 for i, c in
                                   enumerate(cats)}
        self.class_names = tuple(c["name"] for c in cats)
        self.num_classes = len(cats)

        anns_by_sd: Dict[str, List[dict]] = {}
        for ann in table("object_ann"):
            x1, y1, x2, y2 = ann["bbox"]
            if self.is_train and (x2 - x1 < min_box_size
                                  or y2 - y1 < min_box_size):
                continue
            anns_by_sd.setdefault(ann["sample_data_token"], []).append(ann)

        self.examples = []
        for sd in sorted(table("sample_data"), key=lambda s: s["token"]):
            if not sd.get("is_key_frame", False):
                continue  # 2D annotations exist only for key frames
            anns = anns_by_sd.get(sd["token"], [])
            if self.is_train and not anns:
                continue
            self.examples.append((sd, anns))

    def __len__(self) -> int:
        return len(self.examples)

    def image_id(self, index: int) -> str:
        """sample_data token (for results export)."""
        return self.examples[index][0]["token"]

    def example_hw(self, index: int) -> tuple:
        """Original (h, w) from the table — no image decode."""
        sd, _ = self.examples[index]
        return sd["height"], sd["width"]

    def _annotations(self, anns):
        boxes, classes = [], []
        for ann in anns:
            boxes.append([float(v) for v in ann["bbox"]])
            classes.append(self.cat_token_to_class[ann["category_token"]])
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        classes = np.asarray(classes, np.int32)
        n = len(classes)
        areas = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
                 if n else np.zeros((0,), np.float32))
        return (boxes, classes, np.zeros(n, bool),
                np.asarray(areas, np.float32))

    def get_example(self, index: int) -> Dict[str, np.ndarray]:
        sd, anns = self.examples[index]
        path = os.path.join(self.root, sd["filename"])
        img = _pil_image(path).open(path).convert("RGB")
        boxes, classes, crowd, areas = self._annotations(anns)
        return {
            "image": np.asarray(img, np.uint8),
            "boxes": boxes,
            "classes": classes,
            "difficult": crowd,
            "crowd": crowd,
            "area": areas,
            "id": sd["token"],
        }

    def get_raw(self, index: int) -> Dict[str, np.ndarray]:
        """Undecoded variant for the native C++ front-end (nuImages camera
        frames are JPEGs); the loader fuses decode+resize+pad in C++."""
        sd, anns = self.examples[index]
        with open(os.path.join(self.root, sd["filename"]), "rb") as f:
            jpeg = f.read()
        boxes, classes, crowd, areas = self._annotations(anns)
        return {"jpeg": jpeg, "boxes": boxes, "classes": classes,
                "difficult": crowd, "crowd": crowd, "area": areas,
                "id": sd["token"]}
