"""Detector models: NCHW (channels-last) layers over f32 parameters,
computing in f32 or bf16."""

from tpudet_torch.models.cascade_rcnn import CascadeRCNN  # noqa: F401
from tpudet_torch.models.deformable_detr import DeformableDETR  # noqa: F401
from tpudet_torch.models.detr import DETR  # noqa: F401
from tpudet_torch.models.faster_rcnn import FasterRCNN  # noqa: F401
from tpudet_torch.models.fcos import FCOS  # noqa: F401
from tpudet_torch.models.keypoint_rcnn import KeypointRCNN  # noqa: F401
from tpudet_torch.models.mask_rcnn import MaskRCNN  # noqa: F401
from tpudet_torch.models.panoptic_fpn import PanopticFPN  # noqa: F401
from tpudet_torch.models.retinanet import RetinaNet  # noqa: F401

MODELS = {"faster_rcnn": FasterRCNN, "mask_rcnn": MaskRCNN,
          "cascade_rcnn": CascadeRCNN, "keypoint_rcnn": KeypointRCNN,
          "panoptic_fpn": PanopticFPN, "retinanet": RetinaNet, "fcos": FCOS,
          "detr": DETR, "deformable_detr": DeformableDETR}


def build_model(cfg, device="cuda"):
    """Detector factory keyed on ``cfg.model``, on ``device`` (the card
    unless the caller passes "cpu"). The port has every family of the JAX
    package: the two-stage Faster R-CNN, Mask R-CNN, Cascade R-CNN,
    Keypoint R-CNN and Panoptic FPN, the one-stage RetinaNet and FCOS, and
    DETR and Deformable DETR; the two-stage families take any backbone,
    ViTDet's ViT with the simple feature pyramid among them."""
    if cfg.model in MODELS:
        return MODELS[cfg.model](cfg, device=device)
    raise ValueError(f"unknown model {cfg.model!r}: the port has "
                     f"{sorted(MODELS)}")
