"""Single-image detection CLI (``tpudet.cli.detect``).

Example:
  python -m tpudet_torch.cli.detect --preset voc_r50 --checkpoint-dir /ckpt \\
      --image dog.jpg --output out.png --score-thresh 0.5

Runs on the CUDA card unless ``--device cpu`` is passed. ``main`` reads and
writes images with PIL; ``detect_image`` takes an array and needs none.
Mask R-CNN's masks and Keypoint R-CNN's keypoints are drawn with the
boxes.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpudet_torch.cli.common import add_common_args, config_from_args
from tpudet_torch.data.preprocess import (
    prepare_example,
    rescale_keypoints_to_original,
    rescale_to_original,
)
from tpudet_torch.data.voc import VOC_CLASSES
from tpudet_torch.models import build_model
from tpudet_torch.train.checkpoint import CheckpointManager
from tpudet_torch.train.state import create_train_state
from tpudet_torch.train.step import make_eval_step


def detect_image(cfg, model, image: np.ndarray, eval_step=None):
    """[h, w, 3] uint8 -> ``(boxes [n, 4], scores [n], classes [n], masks,
    keypoints)`` in original-image coordinates, on ``model``'s device;
    ``masks`` [n, m, m] box-frame probabilities for Mask R-CNN and Panoptic
    FPN (the boxes carry the rescale), ``keypoints`` [n, K, 3] (x, y,
    score) for Keypoint R-CNN, else None."""
    ex = prepare_example(cfg.data, image, np.zeros((0, 4), np.float32),
                         np.zeros(0, np.int32))
    batch = {"image": torch.from_numpy(ex["image"][None]),
             "image_hw": torch.from_numpy(ex["image_hw"][None])}
    step = eval_step or make_eval_step(model, cfg, fused_preprocess=True)
    out = {k: v.cpu().numpy() for k, v in step(batch).items()}
    valid = out["valid"][0]
    boxes = rescale_to_original(out["boxes"][0][valid], ex["image_scale"],
                                ex["orig_hw"])
    masks = out["masks"][0][valid] if "masks" in out else None
    keypoints = None
    if "keypoints" in out:
        keypoints = rescale_keypoints_to_original(
            out["keypoints"][0][valid], ex["image_scale"], ex["orig_hw"])
    return (boxes, out["scores"][0][valid], out["classes"][0][valid], masks,
            keypoints)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--image", required=True)
    p.add_argument("--output", default="detections.png")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--score-thresh", type=float, default=0.5)
    p.add_argument("--ema", action="store_true",
                   help="use the EMA average of the params")
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    from PIL import Image

    from tpudet_torch.eval.visualize import draw_detections

    image = np.asarray(Image.open(args.image).convert("RGB"))
    model = build_model(cfg, device=args.device)
    state = create_train_state(model, cfg.train, seed=0, device=args.device)
    if args.checkpoint_dir:
        state = CheckpointManager(args.checkpoint_dir).restore_eval(state)
    boxes, scores, classes, masks, keypoints = detect_image(
        cfg, state.eval_model(args.ema), image)
    keep = scores >= args.score_thresh
    boxes, scores, classes = boxes[keep], scores[keep], classes[keep]
    if masks is not None:
        masks = masks[keep]
    if keypoints is not None:
        keypoints = keypoints[keep]
    names = VOC_CLASSES if cfg.data.dataset == "voc" else None
    Image.fromarray(draw_detections(image, boxes, classes, scores, names,
                                    masks=masks, keypoints=keypoints)
                    ).save(args.output)
    print(f"{len(boxes)} detections -> {args.output}")
    for b, s, c in zip(boxes, scores, classes):
        label = names[c - 1] if names else str(int(c))
        print(f"  {label:14s} {s:.3f}  [{b[0]:.1f}, {b[1]:.1f}, {b[2]:.1f}, "
              f"{b[3]:.1f}]")
    return boxes, scores, classes


if __name__ == "__main__":
    main()
