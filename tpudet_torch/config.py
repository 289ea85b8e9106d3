"""Configuration for the PyTorch port (the fields of ``tpudet.config`` that
Faster R-CNN, Mask R-CNN, Cascade R-CNN, Keypoint R-CNN and Panoptic FPN
inference and training, single-level and FPN, RetinaNet, FCOS, DETR and
Deformable DETR inference and training, the data path and the evaluators
read).

Field names and defaults are those of the JAX package's dataclasses, so a
config built for one package reads the same in the other; a test holds the
defaults equal. Groups and fields the port does not run yet (the other
families, TPU-only knobs) are left out until their slice lands;
``TrainConfig`` has every field of the JAX group, though the port reads only
the optimizer, schedule, EMA, accumulation, freeze and seed fields so far.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset, resize, canvas, normalization, train-time augmentation,
    instance masks, semantic maps and keypoints (the JAX group's fields)."""

    dataset: str = "voc"  # "voc" | "coco" | "synthetic"
    data_dir: str = ""
    split: str = "train"
    num_classes: int = 20  # foreground classes (VOC=20, COCO=80)
    # Aspect-preserving resize: min side -> min_size, max side at most
    # max_size (Fast R-CNN's 600/1000).
    min_size: int = 600
    max_size: int = 1000
    # Static canvas the resized image is padded onto.
    canvas_height: int = 1024
    canvas_width: int = 1024
    # Two canvases by orientation: landscape (canvas_short, canvas_width),
    # portrait (canvas_height, canvas_short).
    orientation_buckets: bool = False
    canvas_short: int = 768
    # Aspect-ratio buckets (supersede orientation_buckets): each entry is an
    # (h, w) canvas; an image goes to the one that fits its resized shape
    # with the fewest padded pixels, and the loader batches per bucket. The
    # largest side over all buckets bounds every box coordinate (see
    # _nms_offset).
    aspect_buckets: Tuple[Tuple[int, int], ...] = ()
    # GT boxes are padded to this many per image with a validity mask
    # (Deformable DETR's build check: num_queries >= max_gt_boxes).
    max_gt_boxes: int = 100
    # Per-channel normalization (ImageNet RGB means/stds).
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    # Train-time random horizontal flip (on the device, in the train step).
    random_flip: bool = True
    shuffle_buffer: int = 1000  # kept for parity, not read (as in JAX)
    # Host front-end: "native" fuses JPEG decode, resize and pad in C++
    # (tpudet_torch/native), "pil" decodes with PIL and resizes in torch,
    # "auto" is native where the dataset has JPEGs and the library builds.
    decoder: str = "auto"
    # The native decoder's libjpeg IDCT scaling to the smallest size >= the
    # resize target (faster, within a few levels of the exact decode).
    fast_jpeg_scale: bool = True
    # Train-time photometric jitter (brightness, contrast, saturation, hue),
    # all-zero disables: factors ~ U(1 - x, 1 + x), hue ~ U(-h, h) turns as
    # a YIQ rotation; on the device, over the valid region only.
    color_jitter: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    # Train-time multi-scale jitter of the resize, U(lo, hi), on the host,
    # per (seed, epoch, index); the canvas comes from the unjittered size.
    scale_jitter: Tuple[float, float] = (1.0, 1.0)
    # Instance masks (Mask R-CNN): the loader emits ``gt_masks``
    # [max_gt_boxes, gt_mask_size, gt_mask_size] uint8, each instance's mask
    # rasterized in its own box frame (data/masks.py); a dataset without
    # mask annotations gives zeros.
    load_masks: bool = False
    gt_mask_size: int = 112
    # Semantic maps (Panoptic FPN): the loader emits ``gt_semantic``
    # [canvas_h/4, canvas_w/4] int32 at the semantic branch's loss scale
    # (0 void and padding, 1..num_stuff_classes stuff, then the thing
    # classes shifted by num_stuff_classes), each cell the original map's
    # pixel nearest to its canvas centre.
    load_semantic: bool = False
    num_stuff_classes: int = 1  # synthetic: one background stuff class
    # Keypoints (Keypoint R-CNN): the loader emits ``gt_keypoints``
    # [max_gt_boxes, num_keypoints, 3] = (x, y, v) in canvas pixels, v the
    # COCO visibility (0 unlabeled, 1 labeled and hidden, 2 visible); a
    # dataset without keypoint annotations gives zeros.
    load_keypoints: bool = False
    num_keypoints: int = 17  # COCO person
    # Left/right keypoint pairs swapped by the horizontal flip (COCO person:
    # eyes, ears, shoulders, elbows, wrists, hips, knees, ankles).
    keypoint_flip_pairs: Tuple[Tuple[int, int], ...] = (
        (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14),
        (15, 16),
    )
    # Per-keypoint OKS falloff constants (pycocotools' COCO-17 sigmas): one
    # per keypoint when evaluating.
    keypoint_sigmas: Tuple[float, ...] = (
        0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
        0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
    )


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """Conv feature extractor."""

    # "resnet18" | "resnet34" | "resnet50" | "resnet101" | "vgg16" | a ViT
    # of models/vit.py's VIT_VARIANTS | "tiny" (tests).
    name: str = "resnet50"
    # False: the single c4 map (stride 16) through the neck; True: FPN
    # p2..p6 (models/fpn.py).
    use_fpn: bool = False
    norm: str = "frozen_bn"  # "frozen_bn" | "gn"
    # 1x1 conv + ReLU reducing c4 before the RPN/RoI path; 0 disables.
    # Not read with FPN, whose levels are already 256 wide.
    neck_channels: int = 256
    # Training: no gradient into the ResNet stem and stage c2 (their
    # parameters still take weight decay). The tiny backbone ignores it.
    freeze_stem: bool = True
    # Compute dtype of convs and matmuls; parameters stay float32.
    dtype: str = "float32"  # "float32" | "bfloat16"
    # True: stride on the first 1x1 of a bottleneck (Keras/caffe);
    # False: stride on the 3x3 (torchvision "v1.5"). Basic blocks ignore it.
    stride_in_1x1: bool = True
    # ResNets: the 7x7/2 stem as the equal 4x4/1 conv on the block-2
    # space-to-depth image (models/resnet.py::stem_kernel_to_s2d converts a
    # standard stem's weight).
    s2d_stem: bool = False
    # Training: recompute each backbone block (ResNet block, ViT block, VGG
    # stage) in the backward pass instead of keeping its activations
    # (torch.utils.checkpoint). Values and gradients are unchanged; inference
    # is unaffected.
    remat: bool = False
    # ViTDet (models/vit.py): the side of a windowed block's window, every
    # k-th block attends globally (depth 12, k=3: four global blocks), and
    # the side of the square position-embedding grid (resized to the canvas
    # token grid at call time).
    vit_window: int = 14
    vit_global_attn_every: int = 3
    vit_pos_grid: int = 64
    # ViTDet: detectron2's decomposed relative positions in every block
    # (``use_rel_pos``): tables of [2 * vit_window - 1, head_dim] in window
    # blocks and [2 * vit_pos_grid - 1, head_dim] in global ones. A field of
    # the port alone; the JAX package has no relative positions.
    vit_rel_pos: bool = False


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
    """RPN head, proposal generation and the RPN's training targets."""

    conv_channels: int = 512
    # Proposals: decode -> clip -> min-size -> pre-NMS top-k -> NMS ->
    # post-NMS top-N, with the train or test counts.
    pre_nms_topk_train: int = 12000
    post_nms_topk_train: int = 2000
    pre_nms_topk_test: int = 6000
    post_nms_topk_test: int = 300
    nms_thresh: float = 0.7
    min_box_size: float = 0.0
    box_reg_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    # FPN: pre-NMS top-k per level, NMS within each level (level-offset),
    # post-NMS top-N over the union; 0 -> one global top-k over the pyramid.
    fpn_pre_nms_topk_per_level_train: int = 2000
    fpn_pre_nms_topk_per_level_test: int = 1000
    # Targets (Faster R-CNN §3.1.2): positive at IoU >= fg or the best
    # anchor of a ground-truth box, negative below bg, else ignored.
    fg_iou_thresh: float = 0.7
    bg_iou_thresh: float = 0.3
    # Sampling (§3.1.3): this many anchors per image, up to this share
    # positive.
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5
    loss_weight_box: float = 1.0
    # Anchors that cross the image's border are ignored in training.
    ignore_cross_boundary: bool = True
    # Pre-NMS top-k: "exact" (a stable full sort, lax.top_k's tie order),
    # "blocked" (ops.selection.blocked_top_k, bit-identical to "exact") or
    # "approx" (the JAX package's partial selection at topk_recall_target at
    # inference; here the exact top-k, which approx approximates).
    topk_method: str = "exact"
    # Recall target of topk_method="approx"; read by nothing here.
    topk_recall_target: float = 0.95
    # Row width of the first stage of topk_method="blocked".
    topk_block_size: int = 8192


@dataclasses.dataclass(frozen=True)
class ROIConfig:
    """RoI pooling, Fast R-CNN head and inference post-processing."""

    # "roi_align": the single-level RoI Align kernel, or with FPN each RoI
    # pooled at its FPN-paper level; "roi_align_window" (FPN): the same
    # pooling kernel with the level bumped until the RoI spans at most
    # window - 12 cells (ops.roi_align.fpn_assign_levels);
    # "roi_align_gather", "roi_align_pallas", "roi_align_packed": the JAX
    # package's other formulations of roi_align's value, the same kernel
    # here; "crop_and_resize": tf.image.crop_and_resize's convention
    # (ops.roi_align.crop_and_resize), with FPN at each RoI's FPN-paper level.
    pooler: str = "roi_align"
    # Fit window of pooler="roi_align_window", in cells; every canvas side
    # must satisfy side / 32 <= window - 12 (checked at model build).
    window: int = 56
    # TPU layout and memory knobs of the JAX package's poolers (one Pallas
    # grid over the batch; chunked gathers and einsums): accepted and not
    # read here, where each pooler is one kernel launch per batch.
    window_batched: bool = False
    pooler_chunk: int = 64
    mxu_chunk_budget_mb: int = 256
    output_size: int = 7
    sampling_ratio: int = 2  # samples per bin side
    fc_dim: int = 1024
    box_reg_weights: Tuple[float, float, float, float] = (10.0, 10.0, 5.0, 5.0)
    class_agnostic_bbox: bool = False
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    max_detections: int = 100
    # "hard" (greedy) | "soft_linear" | "soft_gaussian" (Soft-NMS).
    nms_method: str = "hard"
    soft_nms_sigma: float = 0.5
    # Candidate cap for the final NMS: 0 -> 1024, -1 -> all P*C candidates.
    max_nms_candidates: int = 0
    # Training targets (Fast R-CNN §2.3): foreground at IoU >= fg,
    # background in [bg_lo, bg_hi), else ignored; this many RoIs per image,
    # up to this share foreground; the ground truth joins the proposals.
    fg_iou_thresh: float = 0.5
    bg_iou_thresh_hi: float = 0.5
    bg_iou_thresh_lo: float = 0.0
    batch_size_per_image: int = 128
    positive_fraction: float = 0.25
    append_gt: bool = True


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Cascade R-CNN (Cai & Vasconcelos, arXiv:1712.00726): detection heads
    trained at rising IoU thresholds, each refining the boxes of the one
    before. Stage 1 samples with the shared balanced sampler; later stages
    relabel the same RoIs at their threshold (no resampling). Boxes are
    class-agnostic in every stage. Every field and default of the JAX
    group."""

    # Foreground IoU threshold of each stage (and the stage count).
    stage_iou_thresholds: Tuple[float, ...] = (0.5, 0.6, 0.7)
    # Box-delta normalization of each stage (tighter boxes, tighter stds).
    stage_box_reg_weights: Tuple[Tuple[float, float, float, float], ...] = (
        (10.0, 10.0, 5.0, 5.0),
        (20.0, 20.0, 10.0, 10.0),
        (30.0, 30.0, 15.0, 15.0),
    )
    # Loss weight of each stage (the paper's: equal).
    stage_loss_weights: Tuple[float, ...] = (1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class RetinaNetConfig:
    """RetinaNet (Lin et al., arXiv:1708.02002): P3-P7, conv towers shared
    across levels, sigmoid focal loss over every anchor. Every field and
    default of the JAX group."""

    # Head towers (paper §4: four 3x3 convs of 256 per tower).
    num_convs: int = 4
    head_channels: int = 256
    # Every anchor starts at foreground probability prior_prob (§3.3).
    prior_prob: float = 0.01
    # Focal loss -alpha_t (1 - p_t)^gamma log(p_t) (Eq. 4-5).
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    # Assignment: foreground at IoU >= 0.5, background below 0.4, the band
    # between ignored; each ground-truth box also claims its best anchors.
    fg_iou_thresh: float = 0.5
    bg_iou_thresh: float = 0.4
    smooth_l1_beta: float = 0.11
    loss_weight_box: float = 1.0
    box_reg_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    # Inference: per level the top-k (anchor, class) pairs, then one
    # class-aware NMS over the levels' union.
    pre_nms_topk: int = 1000
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    max_detections: int = 100
    # The per-level selection: "off" is the flattened (anchor, class)
    # top-k; "on" takes each anchor's best class first, the top-k of those
    # anchors, then the top-k of their class rows; "auto" is "on" but the
    # eval CLI (the parity referee) pins it to "off".
    prefilter: str = "auto"
    # Final NMS: "hard" | "soft_linear" | "soft_gaussian".
    nms_method: str = "hard"
    soft_nms_sigma: float = 0.5


@dataclasses.dataclass(frozen=True)
class FCOSConfig:
    """FCOS (Tian et al., arXiv:1904.01355): per-location classification,
    (l, t, r, b) distances and centerness on P3-P7, no anchors. Every field
    and default of the JAX group."""

    # Shared towers (§3.1: four 3x3 convs + GroupNorm per tower).
    num_convs: int = 4
    head_channels: int = 256
    head_norm: str = "gn"  # "gn" | "none"
    prior_prob: float = 0.01
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    # A location is a candidate for a box when it lies within radius *
    # stride of its centre (0: anywhere inside it) and its largest distance
    # falls in the level's range; ties go to the smallest box.
    center_sampling_radius: float = 1.5
    # Level i regresses (bounds[i-1], bounds[i]], the last level to inf.
    regress_range_bounds: Tuple[float, ...] = (64.0, 128.0, 256.0, 512.0)
    loss_weight_box: float = 1.0
    loss_weight_ctr: float = 1.0
    # Inference: per level the top-k of sigmoid(class) * sigmoid(ctr), then
    # one class-aware NMS.
    pre_nms_topk: int = 1000
    score_thresh: float = 0.05
    nms_thresh: float = 0.6
    max_detections: int = 100
    nms_method: str = "hard"
    soft_nms_sigma: float = 0.5


@dataclasses.dataclass(frozen=True)
class DETRConfig:
    """DETR (Carion et al., arXiv:2005.12872): a transformer encoder over
    the C5 tokens and a decoder over learned queries, trained with
    Hungarian-matched set losses. Every field and default of the JAX
    group."""

    # Transformer (paper appendix: d=256, 8 heads, 6+6 layers, FFN 2048).
    d_model: int = 256
    num_heads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    ffn_dim: int = 2048
    num_queries: int = 100
    dropout: float = 0.1
    # Matching costs (§2: class probability, L1, GIoU at 1/5/2).
    cost_class: float = 1.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    # Loss weights; eos_coef weighs the no-object class in the CE.
    loss_weight_class: float = 1.0
    loss_weight_bbox: float = 5.0
    loss_weight_giou: float = 2.0
    eos_coef: float = 0.1
    # The set loss on every decoder layer's output (§3.4).
    aux_loss: bool = True
    # Inference: top-k over the (query, class) posterior, no NMS.
    score_thresh: float = 0.05
    max_detections: int = 100


@dataclasses.dataclass(frozen=True)
class DeformableDETRConfig:
    """Deformable DETR (Zhu et al., arXiv:2010.04159): multi-scale
    deformable attention over C3..C5 + extra strided levels, reference-point
    box regression with optional per-layer iterative refinement. Every field
    and default of the JAX package's group."""

    # Transformer (paper §5: d=256, 8 heads, 6+6 layers, FFN 1024,
    # 300 queries, 4 levels x 4 points).
    d_model: int = 256
    num_heads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    ffn_dim: int = 1024
    num_queries: int = 300
    num_levels: int = 4
    num_points: int = 4
    dropout: float = 0.1
    # Iterative bounding-box refinement (paper §4.4): per-layer heads, each
    # decoder layer re-estimates the box around the previous layer's.
    with_box_refine: bool = False
    # Matching cost and loss weights (appendix A.4), focal loss (training).
    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    loss_weight_class: float = 2.0
    loss_weight_bbox: float = 5.0
    loss_weight_giou: float = 2.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    aux_loss: bool = True
    # Inference: top-k over the flattened (query, class) sigmoid scores.
    score_thresh: float = 0.05
    max_detections: int = 100
    # "flat", "patch" or "mxu": three TPU formulations of one function; in
    # the port all three reach the same op (the Hopper kernel on the card).
    sampling_gather: str = "flat"
    # Head-shared sampling locations (a model variant: the offsets layer
    # loses its head axis, the locations are broadcast over the heads).
    # Requires sampling_gather="patch".
    shared_sampling_locations: bool = False
    # Query tile of the TPU's one-hot kernel; kept for parity, not read.
    mxu_query_tile: int = 128


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """Mask R-CNN's mask branch (He et al., arXiv:1703.06870 §3): an FCN
    over RoI features predicting one sigmoid mask per class, trained with a
    per-pixel BCE on the matched class's channel. Every field and default
    of the JAX group."""

    # FCN tower: num_convs 3x3 convs at conv_channels, then a 2x deconv.
    num_convs: int = 4
    conv_channels: int = 256
    # RoI features pooled at this size for the mask branch (the box head
    # pools output_size); the deconv doubles it: masks [2 * size]^2.
    roi_output_size: int = 14
    loss_weight: float = 1.0
    # One mask for every class instead of one per class.
    class_agnostic: bool = False
    # Binarization threshold when pasting predicted masks (eval, visualize).
    binarize_thresh: float = 0.5


@dataclasses.dataclass(frozen=True)
class PanopticConfig:
    """Panoptic FPN's semantic branch (Kirillov et al., arXiv:1901.02446
    §3) and the host-side panoptic fusion. Every field and default of the
    JAX group."""

    conv_channels: int = 128
    loss_weight: float = 0.5  # the paper's lambda for the semantic term
    # Fusion (eval.panoptic.fuse_panoptic): paste instances by score, drop
    # one when more than overlap_thresh of it is claimed already; keep a
    # stuff segment of at least stuff_min_area cells.
    overlap_thresh: float = 0.5
    stuff_min_area: int = 64
    instance_score_thresh: float = 0.5


@dataclasses.dataclass(frozen=True)
class KeypointConfig:
    """Keypoint R-CNN's keypoint branch (He et al., arXiv:1703.06870 §5): an
    FCN over RoI features predicting one heatmap per keypoint, trained as a
    softmax over the heatmap's cells. Every field and default of the JAX
    group."""

    # FCN tower: num_convs 3x3 convs at conv_channels.
    num_convs: int = 8
    conv_channels: int = 512
    # RoI features pooled at this size; the deconv doubles it and a bilinear
    # upsample doubles it again (14 -> 28 -> 56).
    roi_output_size: int = 14
    loss_weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and loop (``tpudet.config.TrainConfig``: every
    field and default). The train CLI reads the checkpoint and logging
    fields; the mesh and ``bf16`` fields are kept for parity and not read
    yet."""

    batch_size: int = 2  # global batch size (per optimizer update)
    # Split each batch into this many microbatches (strided rows, as the
    # JAX step's reshape takes them) and apply one averaged update.
    accum_steps: int = 1
    # "sgd" | "adam" | "adamw": adamw decays decoupled, after the Adam
    # moments; sgd and adam add weight_decay * p to the gradient (coupled).
    optimizer: str = "sgd"
    learning_rate: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    # Scales the backbone's whole update (decay included) after the
    # optimizer core: a param group whose lr is multiplied by it.
    backbone_lr_factor: float = 1.0
    # "step" (lr * lr_gamma at each milestone) or "cosine" (half-cosine to
    # lr_min_factor * learning_rate at total_steps), after a linear warmup.
    lr_schedule: str = "step"
    lr_min_factor: float = 0.0
    lr_milestones: Tuple[int, ...] = (60000,)
    lr_gamma: float = 0.1
    warmup_steps: int = 500
    warmup_factor: float = 1.0 / 3.0
    total_steps: int = 80000
    # EMA of the parameters (0 disables); decay ramps in as
    # min(ema_decay, (1 + n) / (10 + n)) after n updates.
    ema_decay: float = 0.0
    grad_clip_norm: float = 0.0  # 0 disables; optax.clip_by_global_norm
    seed: int = 0
    checkpoint_dir: str = ""
    checkpoint_every: int = 1000
    keep_checkpoints: int = 3
    log_every: int = 20
    num_data_shards: int = -1
    num_model_shards: int = 1
    bf16: bool = False
    # Slash-joined parameter prefixes (the Flax tree's paths, e.g.
    # "backbone") that never change: no gradient, no update, no decay.
    freeze: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """mAP evaluation."""

    iou_thresh: float = 0.5
    # "all_points" (VOC2010+) or "11_points" (VOC2007).
    ap_interpolation: str = "11_points"
    max_images: int = -1


@dataclasses.dataclass(frozen=True)
class Config:
    model: str = "faster_rcnn"
    data: DataConfig = DataConfig()
    backbone: BackboneConfig = BackboneConfig()
    anchors: AnchorConfig = AnchorConfig()
    rpn: RPNConfig = RPNConfig()
    roi: ROIConfig = ROIConfig()
    retinanet: RetinaNetConfig = RetinaNetConfig()
    fcos: FCOSConfig = FCOSConfig()
    cascade: CascadeConfig = CascadeConfig()
    detr: DETRConfig = DETRConfig()
    deformable_detr: DeformableDETRConfig = DeformableDETRConfig()
    mask: MaskConfig = MaskConfig()
    keypoint: KeypointConfig = KeypointConfig()
    panoptic: PanopticConfig = PanopticConfig()
    train: TrainConfig = TrainConfig()
    eval: EvalConfig = EvalConfig()
    # Kept for parity with the JAX config and never read: the port
    # dispatches by the tensor's device alone (a CUDA tensor goes to the
    # hand-written kernel, a CPU tensor to its plain PyTorch version).
    use_pallas: bool = True
    # Predict returns the proposals as class-agnostic detections; training
    # computes the RPN's losses only.
    rpn_only: bool = False
    # Training computes the detection head's losses only, over proposals
    # from an RPN that train.freeze must hold fixed ("rpn_head").
    det_only: bool = False

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def tiny_test_config(canvas: int = 128, num_classes: int = 3,
                     use_fpn: bool = False) -> Config:
    """Small config for the CPU tests: tiny backbone, small canvas (the
    fields of ``tpudet.config.tiny_test_config``)."""
    return Config(
        data=DataConfig(
            dataset="synthetic",
            num_classes=num_classes,
            min_size=canvas,
            max_size=canvas,
            canvas_height=canvas,
            canvas_width=canvas,
            max_gt_boxes=10,
        ),
        backbone=BackboneConfig(name="tiny", use_fpn=use_fpn, norm="gn",
                                freeze_stem=False),
        anchors=AnchorConfig(scales=(32.0, 64.0), aspect_ratios=(0.5, 1.0, 2.0)),
        rpn=RPNConfig(
            conv_channels=64,
            pre_nms_topk_train=512,
            post_nms_topk_train=128,
            pre_nms_topk_test=256,
            post_nms_topk_test=64,
            batch_size_per_image=64,
        ),
        roi=ROIConfig(fc_dim=64, batch_size_per_image=32, max_detections=20),
        train=TrainConfig(batch_size=2, checkpoint_every=10**9),
        use_pallas=False,
    )


def tiny_vitdet_config(canvas: int = 128, num_classes: int = 3) -> Config:
    """Small ViTDet config for the CPU tests (the fields of
    ``tpudet.config.tiny_vitdet_config``): vit_tiny (width 32, two blocks,
    window 4, the second block global) and the simple feature pyramid over
    the tiny two-stage knobs. A 128 px canvas is an 8x8 token grid, the
    position grid's own size; another canvas resizes it."""
    base = tiny_test_config(canvas=canvas, num_classes=num_classes)
    return base.replace(
        backbone=dataclasses.replace(
            base.backbone, name="vit_tiny", use_fpn=True,
            vit_window=4, vit_global_attn_every=2, vit_pos_grid=8))


def tiny_retinanet_config(canvas: int = 128, num_classes: int = 3) -> Config:
    """Small RetinaNet config for the CPU tests (the fields of
    ``tpudet.config.tiny_retinanet_config``): the tiny backbone with the FPN
    (c3..c5 at strides 8/16/32, P6 and P7 grown by stride-2 convs), anchors
    of 16..128 px at two sub-octaves and three ratios, 2 towers of 64, 64
    candidates per level, 20 detections, gradients clipped at 10."""
    base = tiny_test_config(canvas=canvas, num_classes=num_classes)
    return base.replace(
        model="retinanet",
        backbone=dataclasses.replace(base.backbone, use_fpn=True),
        anchors=AnchorConfig(
            aspect_ratios=(0.5, 1.0, 2.0),
            fpn_strides=(8, 16, 32, 64, 128),
            fpn_scales=(16.0, 32.0, 64.0, 96.0, 128.0),
            fpn_octave_scales=(1.0, 1.26),
        ),
        retinanet=RetinaNetConfig(num_convs=2, head_channels=64,
                                  pre_nms_topk=64, max_detections=20),
        train=dataclasses.replace(base.train, grad_clip_norm=10.0),
    )


def tiny_fcos_config(canvas: int = 128, num_classes: int = 3) -> Config:
    """Small FCOS config for the CPU tests (the fields of
    ``tpudet.config.tiny_fcos_config``): the tiny RetinaNet's pyramid,
    2 GroupNorm towers of 64, regression ranges 16/32/64/96 for the 128-px
    canvas, 64 candidates per level, 20 detections, clip 10."""
    base = tiny_test_config(canvas=canvas, num_classes=num_classes)
    return base.replace(
        model="fcos",
        backbone=dataclasses.replace(base.backbone, use_fpn=True),
        anchors=AnchorConfig(fpn_strides=(8, 16, 32, 64, 128)),
        fcos=FCOSConfig(num_convs=2, head_channels=64, pre_nms_topk=64,
                        max_detections=20,
                        regress_range_bounds=(16.0, 32.0, 64.0, 96.0)),
        train=dataclasses.replace(base.train, grad_clip_norm=10.0),
    )


def tiny_detr_config(canvas: int = 128, num_classes: int = 3) -> Config:
    """Small DETR config for the CPU tests (the fields of
    ``tpudet.config.tiny_detr_config``): the tiny backbone (a 4x4 grid of
    C5 tokens at 128 px), a 2+2-layer transformer of width 32 with 4 heads,
    20 queries, dropout off."""
    base = tiny_test_config(canvas=canvas, num_classes=num_classes)
    return base.replace(
        model="detr",
        detr=DETRConfig(d_model=32, num_heads=4, enc_layers=2, dec_layers=2,
                        ffn_dim=64, num_queries=20, dropout=0.0,
                        max_detections=20),
    )


def tiny_deformable_detr_config(canvas: int = 128,
                                num_classes: int = 3) -> Config:
    """Small Deformable DETR config for the CPU tests (the fields of
    ``tpudet.config.tiny_deformable_detr_config``): tiny backbone (C3..C5
    at strides 8/16/32 + one extra stride-64 level), a 2+2-layer transformer
    of width 32 with 4 heads, 20 queries, 2 points, dropout off."""
    base = tiny_test_config(canvas=canvas, num_classes=num_classes)
    return base.replace(
        model="deformable_detr",
        deformable_detr=DeformableDETRConfig(
            d_model=32, num_heads=4, enc_layers=2, dec_layers=2,
            ffn_dim=64, num_queries=20, num_levels=4, num_points=2,
            dropout=0.0, max_detections=20,
        ),
    )


def tiny_maskrcnn_config(canvas: int = 128, num_classes: int = 3) -> Config:
    """Small Mask R-CNN config for the CPU tests (the fields of
    ``tpudet.config.tiny_maskrcnn_config``): the tiny two-stage config with
    mask loading at 28 px crops and a 2-conv, 32-wide FCN pooled at 7."""
    base = tiny_test_config(canvas=canvas, num_classes=num_classes)
    return base.replace(
        model="mask_rcnn",
        data=dataclasses.replace(base.data, load_masks=True, gt_mask_size=28),
        mask=MaskConfig(num_convs=2, conv_channels=32, roi_output_size=7),
    )


def tiny_cascade_config(canvas: int = 128, num_classes: int = 3) -> Config:
    """Small Cascade R-CNN config for the CPU tests (the fields of
    ``tpudet.config.tiny_cascade_config``): the tiny two-stage config with
    class-agnostic boxes and the cascade group's defaults."""
    base = tiny_test_config(canvas=canvas, num_classes=num_classes)
    return base.replace(
        model="cascade_rcnn",
        roi=dataclasses.replace(base.roi, class_agnostic_bbox=True),
    )


def tiny_keypoint_config(canvas: int = 128, num_classes: int = 3) -> Config:
    """Small Keypoint R-CNN config for the CPU tests (the fields of
    ``tpudet.config.tiny_keypoint_config``): the tiny two-stage config with
    the synthetic dataset's 5 keypoints (centre and four edge midpoints;
    pair (1, 2) the left and right ones) and a 2-conv, 32-wide FCN pooled
    at 7."""
    base = tiny_test_config(canvas=canvas, num_classes=num_classes)
    return base.replace(
        model="keypoint_rcnn",
        data=dataclasses.replace(
            base.data, load_keypoints=True, num_keypoints=5,
            keypoint_flip_pairs=((1, 2),),
            keypoint_sigmas=(0.1, 0.1, 0.1, 0.1, 0.1),
        ),
        keypoint=KeypointConfig(num_convs=2, conv_channels=32,
                                roi_output_size=7),
    )


def tiny_panoptic_config(canvas: int = 128, num_classes: int = 3) -> Config:
    """Small Panoptic FPN config for the CPU tests (the fields of
    ``tpudet.config.tiny_panoptic_config``): the tiny Mask R-CNN config
    with the FPN (the semantic head reads p2..p5), semantic maps loaded and
    a 32-wide semantic head."""
    base = tiny_maskrcnn_config(canvas=canvas, num_classes=num_classes)
    return base.replace(
        model="panoptic_fpn",
        backbone=dataclasses.replace(base.backbone, use_fpn=True),
        data=dataclasses.replace(base.data, load_semantic=True),
        panoptic=PanopticConfig(conv_channels=32, stuff_min_area=16),
    )


# Fields kept for ``--set`` parity with tpudet that change nothing here:
# TPU layout and memory knobs, and the recall target of the approximate
# top-k, which the port computes exactly.
NOT_READ = ("rpn.topk_recall_target", "roi.window_batched",
            "roi.pooler_chunk", "roi.mxu_chunk_budget_mb")


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    """Apply ``{"rpn.nms_thresh": 0.6, ...}``-style dotted overrides; a
    field of ``NOT_READ`` is set with a warning that it has no effect."""
    grouped: dict = {}
    for key, value in overrides.items():
        if key in NOT_READ:
            warnings.warn(f"{key}: the port accepts this field for parity "
                          "with tpudet and does not read it", stacklevel=2)
        if "." in key:
            group, field = key.split(".", 1)
            grouped.setdefault(group, {})[field] = value
        else:
            grouped[key] = value
    updates = {}
    for group, fields in grouped.items():
        current = getattr(cfg, group)
        if isinstance(fields, dict) and dataclasses.is_dataclass(current):
            updates[group] = dataclasses.replace(current, **fields)
        else:
            updates[group] = fields
    return dataclasses.replace(cfg, **updates)
