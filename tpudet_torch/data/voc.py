"""PASCAL VOC ingestion (``tpudet.data.voc``, a copy).

Layout: ``{root}/VOCdevkit/VOC{year}/`` with ``Annotations/*.xml``,
``JPEGImages/*.jpg``, ``ImageSets/Main/{split}.txt`` (root may also point
directly at the ``VOC{year}`` directory). VOC XML boxes are 1-based inclusive
pixel corners; converted here to 0-based continuous [x1, y1, x2, y2]."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
_CLASS_TO_ID = {name: i + 1 for i, name in enumerate(VOC_CLASSES)}


def _find_voc_root(root: str, year: str) -> str:
    for cand in (
        root,
        os.path.join(root, f"VOC{year}"),
        os.path.join(root, "VOCdevkit", f"VOC{year}"),
    ):
        if os.path.isdir(os.path.join(cand, "Annotations")):
            return cand
    raise FileNotFoundError(f"no VOC{year} tree under {root!r}")


def parse_voc_xml(path: str, keep_difficult: bool = False):
    """One annotation file -> (boxes [n,4] f32, classes [n] i32, difficult)."""
    tree = ET.parse(path)
    boxes, classes, difficult = [], [], []
    for obj in tree.findall("object"):
        name = obj.findtext("name", "").strip()
        if name not in _CLASS_TO_ID:
            continue
        is_difficult = obj.findtext("difficult", "0").strip() == "1"
        if is_difficult and not keep_difficult:
            continue
        bb = obj.find("bndbox")
        boxes.append(
            [
                float(bb.findtext("xmin")) - 1.0,
                float(bb.findtext("ymin")) - 1.0,
                float(bb.findtext("xmax")) - 1.0,
                float(bb.findtext("ymax")) - 1.0,
            ]
        )
        classes.append(_CLASS_TO_ID[name])
        difficult.append(is_difficult)
    return (
        np.asarray(boxes, np.float32).reshape(-1, 4),
        np.asarray(classes, np.int32),
        np.asarray(difficult, bool),
    )


def _pil_image(path: str):
    """PIL's ``Image``, imported on the first decode of ``path`` (the
    synthetic dataset and the native decoder need no PIL)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"decoding {path} with PIL needs Pillow; the "
                          "synthetic dataset needs none, and data.decoder="
                          "'native' decodes baseline JPEGs without it") from e
    return Image


class VOCDataset:
    num_classes = len(VOC_CLASSES)
    class_names = VOC_CLASSES

    def __init__(
        self,
        root: str,
        split: str = "trainval",
        year: str = "2007",
        keep_difficult: bool = False,
    ):
        self.root = _find_voc_root(root, year)
        self.keep_difficult = keep_difficult
        split_file = os.path.join(
            self.root, "ImageSets", "Main", f"{split}.txt"
        )
        with open(split_file) as f:
            self.ids: List[str] = [line.strip() for line in f if line.strip()]
        self._hw_cache: Dict[int, tuple] = {}

    def __len__(self) -> int:
        return len(self.ids)

    def image_id(self, index: int) -> str:
        """VOC image id (filename stem) — used by results export."""
        return self.ids[index]

    def example_hw(self, index: int) -> tuple:
        """Original (h, w) from the XML <size> tag — no JPEG decode.
        Memoized: bucket planning queries every example once per epoch."""
        cached = self._hw_cache.get(index)
        if cached is not None:
            return cached
        tree = ET.parse(
            os.path.join(self.root, "Annotations", f"{self.ids[index]}.xml")
        )
        size = tree.find("size")
        hw = (int(size.findtext("height")), int(size.findtext("width")))
        self._hw_cache[index] = hw
        return hw

    def _annotations(self, image_id: str):
        return parse_voc_xml(
            os.path.join(self.root, "Annotations", f"{image_id}.xml"),
            self.keep_difficult,
        )

    def _jpeg_path(self, image_id: str) -> str:
        return os.path.join(self.root, "JPEGImages", f"{image_id}.jpg")

    def get_example(self, index: int) -> Dict[str, np.ndarray]:
        image_id = self.ids[index]
        path = self._jpeg_path(image_id)
        img = _pil_image(path).open(path).convert("RGB")
        boxes, classes, difficult = self._annotations(image_id)
        return {
            "image": np.asarray(img, np.uint8),
            "boxes": boxes,
            "classes": classes,
            # VOC eval protocol: difficult GT count neither as npos nor as
            # FPs when matched — the evaluator needs the flags, so eval-mode
            # datasets (keep_difficult=True) carry them through the pipeline.
            "difficult": difficult,
            "id": image_id,
        }

    def get_raw(self, index: int) -> Dict[str, np.ndarray]:
        """``get_example`` with the JPEG's bytes in place of the pixels, for
        the native front end (the loader fuses decode, resize and pad)."""
        image_id = self.ids[index]
        with open(self._jpeg_path(image_id), "rb") as f:
            jpeg = f.read()
        boxes, classes, difficult = self._annotations(image_id)
        return {
            "jpeg": jpeg,
            "boxes": boxes,
            "classes": classes,
            "difficult": difficult,
            "id": image_id,
        }
