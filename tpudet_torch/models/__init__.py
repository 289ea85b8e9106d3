"""Detector models: NCHW (channels-last) layers over f32 parameters,
computing in f32 or bf16."""

from tpudet_torch.models.cascade_rcnn import CascadeRCNN  # noqa: F401
from tpudet_torch.models.deformable_detr import DeformableDETR  # noqa: F401
from tpudet_torch.models.faster_rcnn import FasterRCNN  # noqa: F401
from tpudet_torch.models.keypoint_rcnn import KeypointRCNN  # noqa: F401
from tpudet_torch.models.mask_rcnn import MaskRCNN  # noqa: F401
from tpudet_torch.models.panoptic_fpn import PanopticFPN  # noqa: F401

MODELS = {"faster_rcnn": FasterRCNN, "mask_rcnn": MaskRCNN,
          "cascade_rcnn": CascadeRCNN, "keypoint_rcnn": KeypointRCNN,
          "panoptic_fpn": PanopticFPN, "deformable_detr": DeformableDETR}


def build_model(cfg, device="cuda"):
    """Detector factory keyed on ``cfg.model``. The port has the two-stage
    families Faster R-CNN, Mask R-CNN, Cascade R-CNN, Keypoint R-CNN and
    Panoptic FPN, and Deformable DETR; the other families wait (ROADMAP.md,
    Queue 1 step 4)."""
    if cfg.model in MODELS:
        return MODELS[cfg.model](cfg, device=device)
    raise ValueError(f"unknown model {cfg.model!r}: the port has "
                     f"{sorted(MODELS)}")
