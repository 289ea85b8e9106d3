"""Presets of the configurations the port runs (``tpudet.cli.common``'s
``preset_config`` for ``voc_r50`` and ``tiny``)."""

from __future__ import annotations

from tpudet_torch.config import (
    BackboneConfig,
    Config,
    DataConfig,
    tiny_test_config,
)

# Aspect buckets of the VOC presets: square, 4:3, wide and portrait mirrors.
VOC_BUCKETS = ((640, 640), (640, 832), (640, 1024), (832, 640), (1024, 640))


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
    raise ValueError(f"unknown preset {name!r}: the port has 'voc_r50', 'tiny'")
