"""Evaluation CLI: mAP over a validation split (``tpudet.cli.eval``).

Example:
  python -m tpudet_torch.cli.eval --preset voc_r50 --data-dir /data/voc \\
      --split test --checkpoint-dir /ckpt
  python -m tpudet_torch.cli.eval --preset tiny --dataset synthetic \\
      --checkpoint-dir /tmp/ckpt --device cpu

Runs on the CUDA card unless ``--device cpu`` is passed. The box metrics
(``voc``, ``coco``, ``proposal-recall``); for Mask R-CNN and Panoptic FPN
the same protocol on pasted-mask IoU under ``segm/``; for Keypoint R-CNN
the COCO OKS protocol under ``kp/``; for Panoptic FPN PQ, SQ, RQ and the
semantic mIoU under ``panoptic/``. ``--tta hflip`` also predicts on each
mirrored canvas and merges the two sets (``eval/tta.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from tpudet_torch.cli.common import add_common_args, config_from_args
from tpudet_torch.data import DataLoader, build_dataset
from tpudet_torch.data.masks import mask_to_rle
from tpudet_torch.data.preprocess import (
    rescale_keypoints_to_original,
    rescale_to_original,
)
from tpudet_torch.data.voc import VOC_CLASSES
from tpudet_torch.eval.metrics import (
    CocoStyleEvaluator,
    DetectionEvaluator,
    ProposalRecallEvaluator,
)
from tpudet_torch.eval.panoptic import (
    PanopticEvaluator,
    fuse_panoptic,
    gt_panoptic,
)
from tpudet_torch.eval.tta import (
    flip_batch,
    merge_detections,
    tta_knobs,
    unflip_detections,
)
from tpudet_torch.models import build_model
from tpudet_torch.train.checkpoint import CheckpointManager
from tpudet_torch.train.state import create_train_state
from tpudet_torch.train.step import make_eval_step

# Fetched from the card once per batch (and "masks", "keypoints" and
# "semantic" where the model has them).
_FIELDS = ("boxes", "scores", "classes", "valid", "masks", "keypoints",
           "semantic")


def final_nms_candidates(cfg) -> int:
    """(box, class) candidates per image that enter Faster R-CNN's final
    per-class NMS: every one under ``roi.max_nms_candidates = -1`` (the
    referee), else the cap (0 -> 1024)."""
    from tpudet_torch.models.faster_rcnn import MAX_NMS_CANDIDATES

    every = cfg.rpn.post_nms_topk_test * cfg.data.num_classes
    cap = cfg.roi.max_nms_candidates
    if cap < 0:
        return every
    return min(every, cap or MAX_NMS_CANDIDATES)


def _host_to_device(batch, device):
    """The predict's inputs on ``device``: pinned and copied without a host
    wait on a CUDA card."""
    out = {}
    for k in ("image", "image_hw"):
        t = torch.from_numpy(batch[k])
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def evaluate(cfg, model, dataset, batch_size=8, max_images=-1,
             class_names=None, verbose=True, metric_style="voc",
             save_json="", eval_step=None, tta=""):
    """Batched inference on ``model``'s device and the host-side metrics.

    ``eval_step`` lets a caller that evaluates repeatedly (the train CLI's
    ``--eval-every``) reuse one step. Detections are fetched once per batch;
    up to three batches are in flight, so the host prepares the next ones
    while the card runs. ``tta="hflip"`` predicts each mirrored canvas too
    and merges the unflipped candidates with the originals through the
    family's per-class NMS (about twice the cost)."""
    if tta not in ("", "hflip"):
        raise ValueError(f"unknown tta {tta!r} (use '' or 'hflip')")
    if eval_step is None:
        eval_step = make_eval_step(model, cfg, fused_preprocess=True)
    model.eval()  # dropout off (the train step turns it back on)
    device = model.device
    if metric_style == "proposal_recall":
        # RPN analysis: the caller evaluates with cfg.rpn_only, so predict
        # emits class-agnostic proposals.
        evaluator = ProposalRecallEvaluator()
    elif metric_style == "coco":
        evaluator = CocoStyleEvaluator(cfg.data.num_classes,
                                       class_names=class_names)
    else:
        evaluator = DetectionEvaluator(
            cfg.data.num_classes, iou_thresh=cfg.eval.iou_thresh,
            interpolation=cfg.eval.ap_interpolation, class_names=class_names)
    # Mask R-CNN: a second evaluator of the same protocol matching on
    # pasted-mask IoU, its metrics under "segm/" (the box metrics keep their
    # names). The ground-truth crops ride in the batch with data.load_masks.
    # Keypoint R-CNN: OKS-matched keypoint mAP (a COCO protocol) under
    # "kp/".
    kp_evaluator = None
    if cfg.model == "keypoint_rcnn" and metric_style in ("voc", "coco"):
        if not cfg.data.load_keypoints:
            print("eval: the model emits keypoints but data.load_keypoints="
                  "False: no keypoint mAP (no ground-truth keypoints)")
        elif len(cfg.data.keypoint_sigmas) != cfg.data.num_keypoints:
            raise ValueError(
                f"data.keypoint_sigmas has {len(cfg.data.keypoint_sigmas)} "
                f"entries but num_keypoints={cfg.data.num_keypoints}")
        else:
            kp_evaluator = CocoStyleEvaluator(
                cfg.data.num_classes, class_names=class_names,
                iou_type="keypoints",
                keypoint_sigmas=cfg.data.keypoint_sigmas)
    # Panoptic FPN: PQ, SQ, RQ and the semantic mIoU under "panoptic/",
    # fused and matched on the host at the semantic branch's 1/4 scale.
    pan_evaluator = None
    if cfg.model == "panoptic_fpn" and metric_style in ("voc", "coco"):
        if not (cfg.data.load_semantic and cfg.data.load_masks):
            print("eval: panoptic model without load_semantic/load_masks: "
                  "no PQ")
        else:
            pan_evaluator = PanopticEvaluator(cfg.data.num_stuff_classes,
                                              cfg.data.num_classes)
    segm_evaluator = None
    if cfg.model in ("mask_rcnn", "panoptic_fpn") \
            and metric_style in ("voc", "coco"):
        if not cfg.data.load_masks:
            print("eval: the model emits masks but data.load_masks=False: "
                  "no segm mAP (no ground-truth masks in the batch)")
        elif metric_style == "coco":
            segm_evaluator = CocoStyleEvaluator(
                cfg.data.num_classes, class_names=class_names,
                iou_type="segm")
        else:
            segm_evaluator = DetectionEvaluator(
                cfg.data.num_classes, iou_thresh=cfg.eval.iou_thresh,
                interpolation=cfg.eval.ap_interpolation,
                class_names=class_names, iou_type="segm")
    if verbose and cfg.model in ("faster_rcnn", "mask_rcnn", "keypoint_rcnn",
                                 "panoptic_fpn") and not cfg.rpn_only:
        n = final_nms_candidates(cfg)
        print(f"eval: final NMS over {n} (box, class) candidates per image "
              f"({cfg.rpn.post_nms_topk_test} proposals x "
              f"{cfg.data.num_classes} classes, roi.max_nms_candidates="
              f"{cfg.roi.max_nms_candidates})", flush=True)
    loader = DataLoader(cfg, dataset, batch_size, shuffle=False,
                        drop_last=False)

    def submitted():
        for batch in loader.batches(0):
            batch_valid = batch.pop("batch_valid", np.ones(batch_size, bool))
            inputs = _host_to_device(batch, device)
            flipped = eval_step(flip_batch(inputs)) if tta else None
            yield batch, batch_valid, eval_step(inputs), flipped

    # COCO-format results: image_id from dataset.image_id(index) where the
    # dataset has it (COCO ids, VOC file stems), else the index; category
    # from dataset.category_id(cls), else the contiguous class.
    results = [] if save_json else None
    get_image_id = getattr(dataset, "image_id", lambda i: int(i))
    get_cat_id = getattr(dataset, "category_id", lambda c: int(c))

    seen = 0
    pending = []
    start = time.perf_counter()
    stream = submitted()
    done = False
    while not done or pending:
        while not done and len(pending) < 3:
            try:
                pending.append(next(stream))
            except StopIteration:
                done = True
        if not pending:  # no batch in the split
            break
        batch, batch_valid, out_dev, flip_dev = pending.pop(0)
        out = {k: out_dev[k].cpu().numpy() for k in _FIELDS if k in out_dev}
        fout = None
        if flip_dev is not None:
            fout = unflip_detections(
                {k: flip_dev[k].cpu().numpy() for k in _FIELDS
                 if k in flip_dev}, batch["image_hw"],
                flip_pairs=cfg.data.keypoint_flip_pairs)
        for i in range(len(batch_valid)):
            if not batch_valid[i] or (0 <= max_images <= seen):
                continue
            seen += 1
            if fout is None:
                v = out["valid"][i]
                det = {k: out[k][i][v] for k in ("boxes", "scores", "classes",
                                                 "masks", "keypoints")
                       if k in out}
            else:
                det = merge_detections(out, fout, i, *tta_knobs(cfg))
            boxes = rescale_to_original(det["boxes"], batch["image_scale"][i],
                                        batch["orig_hw"][i])
            # Keypoints rescale once; the records and the OKS evaluator read
            # the same original-pixel array.
            det_kps = None
            if "keypoints" in det:
                det_kps = rescale_keypoints_to_original(
                    det["keypoints"], batch["image_scale"][i],
                    batch["orig_hw"][i])
            gt_valid = batch["gt_valid"][i]
            gt_boxes = rescale_to_original(batch["gt_boxes"][i][gt_valid],
                                           batch["image_scale"][i],
                                           batch["orig_hw"][i])
            if results is not None:
                img_id = get_image_id(int(batch["example_index"][i]))
                masks = det.get("masks", [None] * len(boxes))
                kps = det_kps if det_kps is not None else [None] * len(boxes)
                for b, s, c, mk, kp in zip(boxes, det["scores"],
                                           det["classes"], masks, kps):
                    rec = {
                        "image_id": img_id,
                        "category_id": get_cat_id(int(c)),
                        "bbox": [float(b[0]), float(b[1]),
                                 float(b[2] - b[0]), float(b[3] - b[1])],
                        "score": float(s),
                    }
                    if mk is not None:
                        # Compressed RLE in original-image pixels (the
                        # boxes are rescaled already), as pycocotools reads.
                        rec["segmentation"] = mask_to_rle(
                            mk, b, batch["orig_hw"][i])
                    if kp is not None:
                        # COCO's flat [x1, y1, c1, ...]; the third slot is
                        # the softmax score (COCOeval ignores it).
                        rec["keypoints"] = [
                            float(x) for x in
                            np.asarray(kp, np.float64).reshape(-1)]
                    results.append(rec)
            extra = {}
            if isinstance(evaluator, CocoStyleEvaluator):
                # The COCO protocol bins GT by the annotation's own area, in
                # original pixels, as the rescaled boxes are.
                extra["gt_area"] = batch["gt_area"][i][gt_valid]
            common = dict(gt_difficult=batch["gt_difficult"][i][gt_valid],
                          gt_crowd=batch["gt_crowd"][i][gt_valid], **extra)
            evaluator.add_image(
                boxes, det["scores"], det["classes"], gt_boxes,
                batch["gt_classes"][i][gt_valid], **common)
            if segm_evaluator is not None:
                # Box-frame masks: the boxes carry the rescale to the
                # original image; the crops paste unchanged.
                segm_evaluator.add_image(
                    boxes, det["scores"], det["classes"], gt_boxes,
                    batch["gt_classes"][i][gt_valid],
                    pred_masks=det["masks"],
                    gt_masks=batch["gt_masks"][i][gt_valid], **common)
            if pan_evaluator is not None:
                # Fused in canvas pixels (the boxes before the rescale)
                # against the 1/4-scale semantic maps.
                pc, stuff = cfg.panoptic, cfg.data.num_stuff_classes
                pseg, psegs = fuse_panoptic(
                    det["boxes"], det["scores"], det["classes"],
                    det["masks"], out["semantic"][i], stuff,
                    overlap_thresh=pc.overlap_thresh,
                    stuff_min_area=pc.stuff_min_area,
                    score_thresh=pc.instance_score_thresh)
                gseg, gsegs = gt_panoptic(
                    batch["gt_boxes"][i][gt_valid],
                    batch["gt_classes"][i][gt_valid],
                    batch["gt_masks"][i][gt_valid], batch["gt_semantic"][i],
                    stuff)
                pan_evaluator.add_image(
                    pseg, psegs, gseg, gsegs,
                    pred_semantic=out["semantic"][i],
                    gt_semantic=batch["gt_semantic"][i])
            if kp_evaluator is not None:
                kp_evaluator.add_image(
                    boxes, det["scores"], det["classes"], gt_boxes,
                    batch["gt_classes"][i][gt_valid],
                    pred_keypoints=det_kps,
                    gt_keypoints=rescale_keypoints_to_original(
                        batch["gt_keypoints"][i][gt_valid],
                        batch["image_scale"][i], batch["orig_hw"][i]),
                    **common)
        if 0 <= max_images <= seen:
            break
    del pending, stream
    seconds = time.perf_counter() - start
    if verbose:
        print(f"eval: {seen} images in {seconds:.2f} s "
              f"({seen / max(seconds, 1e-9):.1f} img/s: loader, predict and "
              "metrics)", flush=True)
    if results is not None:
        with open(save_json, "w") as f:
            json.dump(results, f)
        if verbose:
            print(f"wrote {len(results)} detections to {save_json}")
    summary = evaluator.summarize()
    for prefix, ev in (("segm", segm_evaluator), ("kp", kp_evaluator),
                       ("panoptic", pan_evaluator)):
        if ev is not None:
            summary.update({f"{prefix}/{k}": v
                            for k, v in ev.summarize().items()})
    if verbose:
        for k, v in sorted(summary.items()):
            print(f"{k}: {v:.4f}")
    return summary


def referee_config(cfg):
    """The evaluator is the parity referee: every throughput-oriented
    approximation goes back to the protocol-exact form. The final NMS's
    candidate cap sentinel 0 becomes -1 (all P * C (box, class) candidates,
    as the reference's dynamic-shape postprocess; ``--set
    roi.max_nms_candidates=1024`` restores the serving cap), any top-k
    method other than the exact ones becomes "exact", and RetinaNet's
    prefilter "auto" becomes "off" (the paper's flattened (anchor, class)
    selection)."""
    if cfg.roi.max_nms_candidates == 0:
        cfg = cfg.replace(
            roi=dataclasses.replace(cfg.roi, max_nms_candidates=-1))
    if cfg.rpn.topk_method not in ("exact", "blocked"):
        print("eval: forcing rpn.topk_method=exact (parity referee)")
        cfg = cfg.replace(rpn=dataclasses.replace(cfg.rpn, topk_method="exact"))
    if cfg.model == "retinanet" and cfg.retinanet.prefilter == "auto":
        cfg = cfg.replace(retinanet=dataclasses.replace(cfg.retinanet,
                                                        prefilter="off"))
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--split", default="val")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--max-images", type=int, default=-1)
    p.add_argument("--metric", default="",
                   choices=["", "voc", "coco", "proposal-recall"],
                   help="default: coco for COCO datasets, voc otherwise. "
                        "proposal-recall: recall of the ground truth at IoU "
                        "0.5/0.7 by top-k proposals (an rpn_only predict)")
    p.add_argument("--no-mesh", action="store_true",
                   help="accepted for the JAX CLI's flags; one card has no "
                        "mesh")
    p.add_argument("--save-json", default="",
                   help="write detections as a COCO-format results json")
    p.add_argument("--ema", action="store_true",
                   help="evaluate the EMA average of the params "
                        "(train.ema_decay > 0 during training)")
    p.add_argument("--tta", default="", choices=["", "hflip"],
                   help="test-time augmentation: also predict on each "
                        "mirrored image and merge the candidates (~2x cost)")
    args = p.parse_args(argv)
    cfg = referee_config(config_from_args(args))
    metric = args.metric or ("coco" if cfg.data.dataset in ("coco", "nuimages")
                             else "voc")
    if metric == "proposal-recall":
        if cfg.model not in ("faster_rcnn", "mask_rcnn"):
            raise SystemExit(
                "--metric proposal-recall analyses the RPN's proposals; "
                f"model={cfg.model!r} has no proposal stage")
        metric = "proposal_recall"
        # Enough survivors to fill the top-k table, and predict's
        # truncation to max_detections lifted to match.
        cfg = cfg.replace(
            rpn_only=True,
            rpn=dataclasses.replace(
                cfg.rpn,
                post_nms_topk_test=max(cfg.rpn.post_nms_topk_test, 1000)),
            roi=dataclasses.replace(
                cfg.roi, max_detections=max(cfg.roi.max_detections, 1000)))
    model = build_model(cfg, device=args.device)
    state = create_train_state(model, cfg.train, seed=0, device=args.device)
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir)
        state = mgr.restore_eval(state)
        print(f"restored step {mgr.latest_step}")
    dataset = build_dataset(cfg, split=args.split)
    names = VOC_CLASSES if cfg.data.dataset == "voc" else getattr(
        dataset, "class_names", None)
    return evaluate(cfg, state.eval_model(args.ema), dataset,
                    batch_size=args.batch_size, max_images=args.max_images,
                    class_names=names, metric_style=metric,
                    save_json=args.save_json, tta=args.tta)


if __name__ == "__main__":
    main()
