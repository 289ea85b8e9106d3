"""Detector models: NCHW (channels-last) layers over f32 parameters,
computing in f32 or bf16."""

from tpudet_torch.models.deformable_detr import DeformableDETR  # noqa: F401
from tpudet_torch.models.faster_rcnn import FasterRCNN  # noqa: F401
from tpudet_torch.models.mask_rcnn import MaskRCNN  # noqa: F401

MODELS = {"faster_rcnn": FasterRCNN, "mask_rcnn": MaskRCNN,
          "deformable_detr": DeformableDETR}


def build_model(cfg, device="cuda"):
    """Detector factory keyed on ``cfg.model``. The port has Faster R-CNN,
    Mask R-CNN and Deformable DETR; the other families wait (ROADMAP.md,
    Queue 1 step 4)."""
    if cfg.model in MODELS:
        return MODELS[cfg.model](cfg, device=device)
    raise ValueError(f"unknown model {cfg.model!r}: the port has "
                     f"{sorted(MODELS)}")
