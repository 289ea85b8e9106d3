"""Shared CLI plumbing (``tpudet.cli.common``): the presets of the
configurations the port runs (``PRESETS``) and the flags every CLI takes,
with dotted ``--set`` overrides."""

from __future__ import annotations

import argparse
import ast
import dataclasses

from tpudet_torch.config import (
    AnchorConfig,
    BackboneConfig,
    Config,
    DataConfig,
    DETRConfig,
    DeformableDETRConfig,
    FCOSConfig,
    ROIConfig,
    RPNConfig,
    TrainConfig,
    apply_overrides,
    tiny_cascade_config,
    tiny_deformable_detr_config,
    tiny_detr_config,
    tiny_fcos_config,
    tiny_keypoint_config,
    tiny_maskrcnn_config,
    tiny_panoptic_config,
    tiny_retinanet_config,
    tiny_test_config,
    tiny_vitdet_config,
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
        # ResNet-50 Faster R-CNN on VOC 2007 (single-level C4, neck 256),
        # Fast R-CNN's 600/1000 resize onto the VOC buckets.
        return Config(
            data=DataConfig(dataset="voc", num_classes=20, min_size=600,
                            max_size=1000, canvas_height=1024,
                            canvas_width=1024, aspect_buckets=VOC_BUCKETS),
            backbone=BackboneConfig(name="resnet50"),
        )
    if name == "voc_vgg16":
        # The paper's Faster R-CNN (arXiv:1506.01497 §4.1): VGG-16 to
        # conv5_3 (stride 16) through the 256 neck, VOC 2007, 600/1000, a
        # 4096-wide fc6/fc7 head.
        return Config(
            data=DataConfig(dataset="voc", num_classes=20, min_size=600,
                            max_size=1000, canvas_height=1024,
                            canvas_width=1024, aspect_buckets=VOC_BUCKETS),
            backbone=BackboneConfig(name="vgg16"),
            roi=ROIConfig(fc_dim=4096),
        )
    if name == "coco_r50":
        # COCO 2017, ResNet-50 to c4 (neck 256), 800/1333 onto the COCO
        # buckets; trained data-parallel (torchrun, parallel/mesh.py).
        return Config(
            data=DataConfig(dataset="coco", num_classes=80, min_size=800,
                            max_size=1333, canvas_height=1344,
                            canvas_width=1344, aspect_buckets=COCO_BUCKETS),
            backbone=BackboneConfig(name="resnet50"),
        )
    if name == "coco_r101_fpn":
        # ResNet-101 + FPN on COCO, bf16: RPN 256 wide, blocked per-level
        # top-1000, 300 proposals (1000 in training), each RoI pooled once at
        # its fit-bumped level (window 56 covers the 1344-px canvases at p5).
        return Config(
            data=DataConfig(dataset="coco", num_classes=80, min_size=800,
                            max_size=1333, canvas_height=1344,
                            canvas_width=1344, aspect_buckets=COCO_BUCKETS),
            backbone=BackboneConfig(name="resnet101", use_fpn=True,
                                    dtype="bfloat16"),
            rpn=RPNConfig(conv_channels=256, post_nms_topk_train=1000,
                          post_nms_topk_test=300, topk_method="blocked"),
            roi=ROIConfig(pooler="roi_align_window", window=56),
        )
    if name == "vitdet_tiny":
        return tiny_vitdet_config()
    if name == "coco_vitdet_b":
        # ViTDet-B Faster R-CNN (arXiv:2203.16527 A.2): a plain ViT-B/16,
        # window 14 with four global blocks, the simple feature pyramid
        # p2..p6, on coco_r101_fpn's pipeline (blocked top-k, windowed
        # pooler); AdamW at 1e-4, weight decay 0.1.
        base = preset_config("coco_r101_fpn")
        return base.replace(
            backbone=dataclasses.replace(base.backbone, name="vit_b",
                                         freeze_stem=False),
            train=dataclasses.replace(base.train, optimizer="adamw",
                                      learning_rate=1e-4, weight_decay=0.1))
    if name == "coco_maskrcnn_r50_fpn":
        # Mask R-CNN R50-FPN (arXiv:1703.06870 §4.1): coco_r101_fpn with a
        # ResNet-50, instance masks loaded, and the mask group's defaults
        # (14x14 pooled, 4 convs of 256, a deconv to 28x28 per class).
        base = preset_config("coco_r101_fpn")
        return base.replace(
            model="mask_rcnn",
            backbone=dataclasses.replace(base.backbone, name="resnet50"),
            data=dataclasses.replace(base.data, load_masks=True))
    if name == "coco_cascade_r50_fpn":
        # Cascade R-CNN R50-FPN (arXiv:1712.00726 §4): coco_r101_fpn with a
        # ResNet-50, three stages at IoU 0.5/0.6/0.7, class-agnostic boxes,
        # the 10/20/30 delta normalization.
        base = preset_config("coco_r101_fpn")
        return base.replace(
            model="cascade_rcnn",
            backbone=dataclasses.replace(base.backbone, name="resnet50"),
            roi=dataclasses.replace(base.roi, class_agnostic_bbox=True))
    if name == "coco_keypoint_r50_fpn":
        # Keypoint R-CNN R50-FPN (arXiv:1703.06870 §5): coco_r101_fpn with a
        # ResNet-50, the person class alone (person_keypoints_*.json), the
        # COCO-17 keypoints and sigmas, the branch pooled at 14, 8 convs of
        # 512 and 56x56 heatmaps.
        base = preset_config("coco_r101_fpn")
        return base.replace(
            model="keypoint_rcnn",
            backbone=dataclasses.replace(base.backbone, name="resnet50"),
            data=dataclasses.replace(base.data, load_keypoints=True,
                                     num_classes=1))
    if name == "coco_panoptic_r50_fpn":
        # Panoptic FPN R50 (arXiv:1901.02446 §5): coco_maskrcnn_r50_fpn with
        # the 128-wide semantic head at loss weight 0.5, COCO panoptic's 80
        # things and 53 stuff classes.
        base = preset_config("coco_maskrcnn_r50_fpn")
        return base.replace(
            model="panoptic_fpn",
            data=dataclasses.replace(base.data, load_semantic=True,
                                     num_stuff_classes=53))
    if name == "maskrcnn_tiny":
        return tiny_maskrcnn_config()
    if name == "cascade_tiny":
        return tiny_cascade_config()
    if name == "keypoint_tiny":
        return tiny_keypoint_config()
    if name == "panoptic_tiny":
        return tiny_panoptic_config()
    if name == "retinanet_tiny":
        return tiny_retinanet_config()
    if name == "coco_retinanet_r50":
        # RetinaNet-R50-FPN on COCO (arXiv:1708.02002 §5): P3-P7, anchors
        # of 32..512 px at three sub-octaves and three ratios, 4-conv towers
        # of 256, focal alpha 0.25, gamma 2, bf16; gradients clipped at 10
        # (the 1/num_pos normalizer spikes on sparse-positive batches).
        return Config(
            model="retinanet",
            data=DataConfig(dataset="coco", num_classes=80, min_size=800,
                            max_size=1333, canvas_height=1344,
                            canvas_width=1344, aspect_buckets=COCO_BUCKETS),
            backbone=BackboneConfig(name="resnet50", use_fpn=True,
                                    dtype="bfloat16"),
            anchors=AnchorConfig(
                fpn_strides=(8, 16, 32, 64, 128),
                fpn_scales=(32.0, 64.0, 128.0, 256.0, 512.0),
                fpn_octave_scales=(1.0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))),
            train=TrainConfig(grad_clip_norm=10.0),
        )
    if name == "fcos_tiny":
        return tiny_fcos_config()
    if name == "coco_fcos_r50":
        # FCOS-R50-FPN on COCO (arXiv:1904.01355 §4): P3-P7, regression
        # ranges 64/128/256/512, 4-conv GroupNorm towers of 256, centre
        # sampling, centerness-weighted GIoU, bf16, clip 10.
        return Config(
            model="fcos",
            data=DataConfig(dataset="coco", num_classes=80, min_size=800,
                            max_size=1333, canvas_height=1344,
                            canvas_width=1344, aspect_buckets=COCO_BUCKETS),
            backbone=BackboneConfig(name="resnet50", use_fpn=True,
                                    dtype="bfloat16"),
            anchors=AnchorConfig(fpn_strides=(8, 16, 32, 64, 128)),
            fcos=FCOSConfig(),
            train=TrainConfig(grad_clip_norm=10.0),
        )
    if name == "detr_tiny":
        return tiny_detr_config()
    if name == "coco_detr_r50":
        # DETR-R50 on COCO (arXiv:2005.12872 §4: d=256, 8 heads, 6+6
        # layers, FFN 2048, 100 queries, costs and weights 1/5/2, eos 0.1,
        # auxiliary losses), single-scale C5, bf16. AdamW at 1e-4 (the
        # backbone at 0.1x), weight decay 1e-4, grad clip 0.1.
        return Config(
            model="detr",
            data=DataConfig(dataset="coco", num_classes=80, min_size=800,
                            max_size=1333, canvas_height=1344,
                            canvas_width=1344, aspect_buckets=COCO_BUCKETS,
                            max_gt_boxes=100),
            backbone=BackboneConfig(name="resnet50", use_fpn=False,
                                    dtype="bfloat16"),
            detr=DETRConfig(),
            train=TrainConfig(optimizer="adamw", learning_rate=1e-4,
                              weight_decay=1e-4, grad_clip_norm=0.1,
                              backbone_lr_factor=0.1),
        )
    if name == "deformable_detr_tiny":
        return tiny_deformable_detr_config()
    if name == "coco_deformable_detr_r50":
        # Deformable-DETR-R50 on COCO (paper §5: d=256, 8 heads, 6+6 layers,
        # FFN 1024, 300 queries, 4 levels x 4 points), iterative box
        # refinement, bf16. C3..C5 + a stride-64 level through the model's
        # own projections: no FPN, no anchors, no NMS. Trains with AdamW at
        # 2e-4 (the backbone at 0.1x), weight decay 1e-4, grad clip 0.1.
        return Config(
            model="deformable_detr",
            data=DataConfig(dataset="coco", num_classes=80, min_size=800,
                            max_size=1333, canvas_height=1344,
                            canvas_width=1344, aspect_buckets=COCO_BUCKETS,
                            max_gt_boxes=100),
            backbone=BackboneConfig(name="resnet50", use_fpn=False,
                                    dtype="bfloat16"),
            deformable_detr=DeformableDETRConfig(with_box_refine=True,
                                                 sampling_gather="mxu"),
            train=TrainConfig(optimizer="adamw", learning_rate=2e-4,
                              weight_decay=1e-4, grad_clip_norm=0.1,
                              backbone_lr_factor=0.1),
        )
    raise ValueError(f"unknown preset {name!r}: the port has {PRESETS}")


PRESETS = ("tiny", "voc_r50", "voc_vgg16", "coco_r50", "coco_r101_fpn",
           "vitdet_tiny", "coco_vitdet_b",
           "maskrcnn_tiny", "coco_maskrcnn_r50_fpn", "deformable_detr_tiny",
           "coco_deformable_detr_r50", "cascade_tiny", "coco_cascade_r50_fpn",
           "keypoint_tiny", "coco_keypoint_r50_fpn", "panoptic_tiny",
           "coco_panoptic_r50_fpn", "retinanet_tiny", "coco_retinanet_r50",
           "fcos_tiny", "coco_fcos_r50", "detr_tiny", "coco_detr_r50")


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--preset", default="voc_r50", choices=PRESETS)
    p.add_argument("--data-dir", default="", help="dataset root")
    p.add_argument("--dataset", default="",
                   help="override the dataset type "
                        "(voc|coco|nuimages|synthetic)")
    p.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="dotted config override, e.g. --set rpn.nms_thresh=0.6")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch versions of the kernels)")


def config_from_args(args: argparse.Namespace) -> Config:
    """The preset, then ``--data-dir``, ``--dataset`` (``synthetic`` on a
    preset other than ``tiny`` sets 8 classes, the synthetic colours) and
    each ``--set`` (values read as Python literals, else as strings)."""
    cfg = preset_config(args.preset)
    overrides = {}
    if args.data_dir:
        overrides["data.data_dir"] = args.data_dir
    if args.dataset:
        overrides["data.dataset"] = args.dataset
        if args.dataset == "synthetic" and args.preset != "tiny":
            overrides.setdefault("data.num_classes", 8)
    for item in args.set:
        key, _, raw = item.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        overrides[key.strip()] = value
    return apply_overrides(cfg, overrides)
