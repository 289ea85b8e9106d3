"""Input pipeline (``tpudet.data``): annotation parsing (VOC XML, COCO JSON,
COCO panoptic JSON and PNGs, nuImages JSON tables, synthetic), decode, the
aspect-preserving resize and padding onto uint8 canvases on the host;
normalization and train-time augmentation on the card
(``preprocess.device_preprocess``)."""

from tpudet_torch.data.coco import CocoDataset  # noqa: F401
from tpudet_torch.data.coco_panoptic import CocoPanopticDataset  # noqa: F401
from tpudet_torch.data.loader import DataLoader, Dataset  # noqa: F401
from tpudet_torch.data.nuimages import NuImagesDataset  # noqa: F401
from tpudet_torch.data.preprocess import (  # noqa: F401
    device_preprocess,
    prepare_example,
)
from tpudet_torch.data.synthetic import SyntheticDataset  # noqa: F401
from tpudet_torch.data.voc import VOC_CLASSES, VOCDataset  # noqa: F401


def build_dataset(cfg, split: str | None = None):
    """Dataset factory: ``data.dataset`` "synthetic", "voc", "coco" (COCO
    panoptic with ``data.load_semantic``) or "nuimages"."""
    d = cfg.data
    split = split or d.split
    if d.dataset == "synthetic":
        return SyntheticDataset(
            num_classes=d.num_classes,
            num_examples=512 if split == "train" else 64,
            seed=0 if split == "train" else 1,
            with_masks=d.load_masks,
            with_keypoints=d.load_keypoints,
            num_keypoints=d.num_keypoints,
            with_semantic=d.load_semantic,
            num_stuff_classes=d.num_stuff_classes,
        )
    if d.dataset == "voc":
        # Eval splits keep the difficult objects with their flags (the VOC
        # protocol ignores them at matching time); training drops them.
        ds = VOCDataset(d.data_dir, split=split,
                        keep_difficult=split in ("test", "val"))
    elif d.dataset == "coco" and d.load_semantic:
        # Panoptic FPN reads the panoptic annotations (JSON and PNG id
        # maps), the only COCO files with stuff segments.
        ds = CocoPanopticDataset(d.data_dir, split=split,
                                 keep_crowd=split in ("val", "val2017"))
        if ds.num_stuff_classes != d.num_stuff_classes:
            raise ValueError(
                f"data.num_stuff_classes={d.num_stuff_classes} but the "
                f"panoptic annotations define {ds.num_stuff_classes} stuff "
                "categories")
    elif d.dataset == "coco":
        # Eval splits keep the crowd annotations as ignore regions;
        # training drops them. Keypoints live only in
        # person_keypoints_*.json (the person category alone).
        ds = CocoDataset(d.data_dir, split=split,
                         keep_crowd=split in ("val", "val2017"),
                         ann_prefix=("person_keypoints" if d.load_keypoints
                                     else "instances"))
    elif d.dataset == "nuimages":
        # nuScenes-style autonomous-driving annotations; no crowd or
        # difficult flags, so eval needs no ignore regions.
        ds = NuImagesDataset(d.data_dir, split=split)
    else:
        raise ValueError(f"unknown dataset {d.dataset!r}")
    # A class-count mismatch would give class ids beyond the heads and the
    # evaluator's banks.
    ds_classes = getattr(ds, "num_classes", None)
    if ds_classes is not None and ds_classes != d.num_classes:
        raise ValueError(
            f"dataset has {ds_classes} classes but cfg.data.num_classes is "
            f"{d.num_classes}: use the matching preset or override "
            "data.num_classes")
    return ds
