"""Configuration for the PyTorch port (the fields of ``tpudet.config`` that
Faster R-CNN inference reads, single-level and FPN).

Field names and defaults are those of the JAX package's dataclasses, so a
config built for one package reads the same in the other; a test holds the
defaults equal. Groups and fields the port does not run yet (training, the
other families, TPU-only knobs) are left out until their slice lands.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input canvas and normalization."""

    num_classes: int = 20  # foreground classes (VOC=20, COCO=80)
    # Static canvas the resized image is padded onto.
    canvas_height: int = 1024
    canvas_width: int = 1024
    # Aspect-ratio buckets: each entry is an (h, w) canvas. The largest side
    # over all buckets bounds every box coordinate (see _nms_offset).
    aspect_buckets: Tuple[Tuple[int, int], ...] = ()
    # Per-channel normalization (ImageNet RGB means/stds).
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """Conv feature extractor."""

    name: str = "resnet50"  # "resnet50" | "resnet101" | "tiny" (tests)
    # False: the single c4 map (stride 16) through the neck; True: FPN
    # p2..p6 (models/fpn.py).
    use_fpn: bool = False
    norm: str = "frozen_bn"  # "frozen_bn" | "gn"
    # 1x1 conv + ReLU reducing c4 before the RPN/RoI path; 0 disables.
    # Not read with FPN, whose levels are already 256 wide.
    neck_channels: int = 256
    # Compute dtype of convs and matmuls; parameters stay float32.
    dtype: str = "float32"  # "float32" | "bfloat16"
    # True: stride on the first 1x1 of a bottleneck (Keras/caffe);
    # False: stride on the 3x3 (torchvision "v1.5").
    stride_in_1x1: bool = True


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor grid (Faster R-CNN §3.1.1: k=9 anchors per cell)."""

    scales: Tuple[float, ...] = (128.0, 256.0, 512.0)
    aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    stride: int = 16
    # FPN: one base scale per level at these strides (p2..p6), each times
    # the octave multipliers (Faster R-CNN FPN keeps the single 1.0).
    fpn_strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    fpn_scales: Tuple[float, ...] = (32.0, 64.0, 128.0, 256.0, 512.0)
    fpn_octave_scales: Tuple[float, ...] = (1.0,)

    @property
    def num_anchors_per_cell(self) -> int:
        return len(self.scales) * len(self.aspect_ratios)

    @property
    def num_fpn_anchors_per_cell(self) -> int:
        return len(self.fpn_octave_scales) * len(self.aspect_ratios)


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    """RPN head and proposal generation (inference knobs)."""

    conv_channels: int = 512
    pre_nms_topk_test: int = 6000
    post_nms_topk_test: int = 300
    nms_thresh: float = 0.7
    min_box_size: float = 0.0
    box_reg_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    # FPN: pre-NMS top-k per level, NMS within each level (level-offset),
    # post-NMS top-N over the union; 0 -> one global top-k over the pyramid.
    fpn_pre_nms_topk_per_level_test: int = 1000
    # Pre-NMS top-k: "exact" (a stable full sort, lax.top_k's tie order) or
    # "blocked" (ops.selection.blocked_top_k, bit-identical to "exact");
    # "approx" (a TPU PartialReduce knob) raises NotImplementedError.
    topk_method: str = "exact"
    # Row width of the first stage of topk_method="blocked".
    topk_block_size: int = 8192


@dataclasses.dataclass(frozen=True)
class ROIConfig:
    """RoI pooling, Fast R-CNN head and inference post-processing."""

    # "roi_align": the single-level RoI Align kernel, or with FPN each RoI
    # pooled at its FPN-paper level; "roi_align_window" (FPN): the same
    # pooling kernel with the level bumped until the RoI spans at most
    # window - 12 cells (ops.roi_align.fpn_assign_levels). The JAX
    # package's other poolers raise NotImplementedError.
    pooler: str = "roi_align"
    # Fit window of pooler="roi_align_window", in cells; every canvas side
    # must satisfy side / 32 <= window - 12 (checked at model build).
    window: int = 56
    output_size: int = 7
    sampling_ratio: int = 2  # samples per bin side
    fc_dim: int = 1024
    box_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    class_agnostic_bbox: bool = False
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    max_detections: int = 100
    # "hard" only; the soft methods raise NotImplementedError.
    nms_method: str = "hard"
    soft_nms_sigma: float = 0.5
    # Candidate cap for the final NMS: 0 -> 1024, -1 -> all P*C candidates.
    max_nms_candidates: int = 0


@dataclasses.dataclass(frozen=True)
class Config:
    model: str = "faster_rcnn"
    data: DataConfig = DataConfig()
    backbone: BackboneConfig = BackboneConfig()
    anchors: AnchorConfig = AnchorConfig()
    rpn: RPNConfig = RPNConfig()
    roi: ROIConfig = ROIConfig()
    # Kept for parity with the JAX config and never read: the port
    # dispatches by the tensor's device alone (a CUDA tensor goes to the
    # hand-written kernel, a CPU tensor to its plain PyTorch version).
    use_pallas: bool = True
    # Predict returns the proposals as class-agnostic detections.
    rpn_only: bool = False

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def tiny_test_config(canvas: int = 128, num_classes: int = 3,
                     use_fpn: bool = False) -> Config:
    """Small config for the CPU tests: tiny backbone, small canvas (the
    inference fields of ``tpudet.config.tiny_test_config``)."""
    return Config(
        data=DataConfig(
            num_classes=num_classes,
            canvas_height=canvas,
            canvas_width=canvas,
        ),
        backbone=BackboneConfig(name="tiny", use_fpn=use_fpn, norm="gn"),
        anchors=AnchorConfig(scales=(32.0, 64.0), aspect_ratios=(0.5, 1.0, 2.0)),
        rpn=RPNConfig(
            conv_channels=64,
            pre_nms_topk_test=256,
            post_nms_topk_test=64,
        ),
        roi=ROIConfig(fc_dim=64, max_detections=20),
        use_pallas=False,
    )
