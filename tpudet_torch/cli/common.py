"""Presets of the configurations the port runs (``tpudet.cli.common``'s
``preset_config`` for ``voc_r50``, ``coco_r101_fpn`` and ``tiny``)."""

from __future__ import annotations

from tpudet_torch.config import (
    BackboneConfig,
    Config,
    DataConfig,
    ROIConfig,
    RPNConfig,
    tiny_test_config,
)

# Aspect buckets of the VOC presets: square, 4:3, wide and portrait mirrors.
VOC_BUCKETS = ((640, 640), (640, 832), (640, 1024), (832, 640), (1024, 640))
# The same for COCO's 800/1333 resize.
COCO_BUCKETS = ((832, 832), (832, 1120), (832, 1344), (1120, 832),
                (1344, 832))


def preset_config(name: str) -> Config:
    if name == "tiny":
        return tiny_test_config()
    if name == "voc_r50":
        # ResNet-50 Faster R-CNN on VOC 2007 (single-level C4, neck 256).
        return Config(
            data=DataConfig(num_classes=20, canvas_height=1024,
                            canvas_width=1024, aspect_buckets=VOC_BUCKETS),
            backbone=BackboneConfig(name="resnet50"),
        )
    if name == "coco_r101_fpn":
        # ResNet-101 + FPN on COCO, bf16: RPN 256 wide, blocked per-level
        # top-1000, 300 proposals, each RoI pooled once at its fit-bumped
        # level (window 56 covers the 1344-px canvases at p5).
        return Config(
            data=DataConfig(num_classes=80, canvas_height=1344,
                            canvas_width=1344, aspect_buckets=COCO_BUCKETS),
            backbone=BackboneConfig(name="resnet101", use_fpn=True,
                                    dtype="bfloat16"),
            rpn=RPNConfig(conv_channels=256, post_nms_topk_test=300,
                          topk_method="blocked"),
            roi=ROIConfig(pooler="roi_align_window", window=56),
        )
    raise ValueError(f"unknown preset {name!r}: the port has 'voc_r50', "
                     "'coco_r101_fpn', 'tiny'")
