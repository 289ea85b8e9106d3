"""Training CLI (``tpudet.cli.train``).

Example:
  python -m tpudet_torch.cli.train --preset tiny --dataset synthetic \\
      --steps 200 --device cpu
  python -m tpudet_torch.cli.train --preset voc_r50 --data-dir /data/voc \\
      --steps 80000 --batch-size 16 --checkpoint-dir /ckpt
  torchrun --nproc-per-node 8 -m tpudet_torch.cli.train --preset coco_r50 \\
      --data-dir /data/coco --batch-size 16 --checkpoint-dir /ckpt

Runs on the CUDA card unless ``--device cpu`` is passed. The loader's uint8
canvases go to the card and the train step normalizes, jitters and flips
them there (``fused_preprocess``). RPN-only training via ``--rpn-only``; the
other stages of the alternating schedule via ``--det-only``, ``--freeze``
and ``--init-from``; pretrained backbone weights (an ``.npz`` of
``models/import_weights.py``'s converters) via ``--backbone-weights``. A
resumed run restarts the loader at epoch 0, as the JAX CLI does.

Under torchrun (``WORLD_SIZE`` in the environment) each process joins the
("data", "model") mesh (NCCL on the cards, gloo with ``--device cpu``) and
drives ``cuda:LOCAL_RANK``. ``--set train.num_model_shards=2`` cuts the
model over pairs of neighbouring ranks (tensor parallelism,
``parallel/sharding_rules.py``), the rest of the world is the data axis
(``train.num_data_shards``, -1: the world over the model axis);
``--batch-size`` is the global batch, which the data axis must divide::

  torchrun --nproc-per-node 4 -m tpudet_torch.cli.train \
      --preset coco_r101_fpn --batch-size 16 \
      --set train.num_model_shards=2 --checkpoint-dir /ckpt

Every process restores the checkpoint (its shards of it); the data rank 0's
model peers join their shards of each checkpoint and rank 0 of the world
alone writes it, the config record and the log; the others wait for it at
a barrier.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch

from tpudet_torch.cli.common import add_common_args, config_from_args
from tpudet_torch.data import DataLoader, build_dataset
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import (
    apply_backbone_weights,
    load_backbone_npz,
)
from tpudet_torch.parallel import init_mesh
from tpudet_torch.train.checkpoint import CheckpointManager
from tpudet_torch.train.state import create_train_state
from tpudet_torch.train.step import make_eval_step, make_train_step
from tpudet_torch.utils.logging import MetricsLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--steps", type=int, default=0, help="override total_steps")
    p.add_argument("--batch-size", type=int, default=0,
                   help="override the batch size")
    p.add_argument("--lr", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--logdir", default="")
    p.add_argument("--rpn-only", action="store_true",
                   help="train only the RPN branch")
    p.add_argument("--det-only", action="store_true",
                   help="train only the detection branch over frozen-RPN "
                        "proposals (implies freezing rpn_head)")
    p.add_argument("--freeze", default="",
                   help="comma-separated parameter-subtree prefixes to "
                        "freeze, e.g. 'backbone' or 'backbone,rpn_head'")
    p.add_argument("--init-from", default="",
                   help="checkpoint dir to warm-start the parameters from "
                        "(a fresh optimizer and step)")
    p.add_argument("--no-mesh", action="store_true",
                   help="one process even under torchrun's environment (no "
                        "data-parallel group)")
    p.add_argument("--log-images-every", type=int, default=0,
                   help="save a GT-annotated training image every N steps "
                        "under --logdir (0 = off; drawing needs PIL)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="mAP on the val split every N steps (0 = off)")
    p.add_argument("--eval-max-images", type=int, default=64)
    p.add_argument("--debug-nans", action="store_true",
                   help="fail on the first non-finite metric (reads every "
                        "step's metrics)")
    p.add_argument("--backbone-weights", default="",
                   help=".npz of converted pretrained backbone weights "
                        "(models/import_weights.py: save_backbone_npz), "
                        "applied before the first step")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = config_from_args(args)
    overrides = {}
    if args.steps:
        overrides["total_steps"] = args.steps
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.lr:
        overrides["learning_rate"] = args.lr
    if args.seed >= 0:
        overrides["seed"] = args.seed
    if args.checkpoint_dir:
        overrides["checkpoint_dir"] = args.checkpoint_dir
    freeze = tuple(s for s in args.freeze.split(",") if s)
    if args.det_only and "rpn_head" not in freeze:
        freeze = freeze + ("rpn_head",)
    if freeze:
        overrides["freeze"] = freeze
    if overrides:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **overrides))
    if args.rpn_only:
        cfg = cfg.replace(rpn_only=True)
    if args.det_only:
        cfg = cfg.replace(det_only=True)
    dp = None
    if "WORLD_SIZE" in os.environ and not args.no_mesh:
        world = int(os.environ["WORLD_SIZE"])
        num_model = cfg.train.num_model_shards
        if num_model < 1 or world % num_model:
            raise ValueError(f"train.num_model_shards {num_model} does not "
                             f"divide the world size {world}")
        num_data = cfg.train.num_data_shards
        if num_data == -1:
            num_data = world // num_model
        if cfg.train.batch_size % num_data:
            # Refused before joining: the loader cannot split the batch.
            raise ValueError(
                f"batch_size {cfg.train.batch_size} not divisible by the "
                f"data-parallel world size {num_data}: "
                "adjust --batch-size (or pass --no-mesh)")
        dp = init_mesh(num_model, num_data, args.device)
    device = dp.device if dp is not None else torch.device(args.device)
    writer = dp is None or dp.global_rank == 0
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + (f", data rank {dp.rank} of {dp.world_size}, model rank "
             f"{dp.model_rank} of {dp.model_size}" if dp is not None
             else ""))
    try:
        return _train(args, cfg, device, dp, writer)
    finally:
        if dp is not None:
            dp.close()


def _train(args, cfg, device, dp, writer):
    model = build_model(cfg, device=device)
    seed = cfg.train.seed
    if args.backbone_weights:
        # Drawn, then the backbone overwritten, before the optimizer and
        # the EMA copy are made.
        model.init(seed)
        apply_backbone_weights(model, *load_backbone_npz(args.backbone_weights))
        print(f"loaded backbone weights from {args.backbone_weights}")
        seed = None
    state = create_train_state(model, cfg.train, seed=seed, device=device,
                               dp=dp)
    if args.init_from:
        # A stage transition: the previous stage's parameters, this stage's
        # fresh optimizer and step.
        state = CheckpointManager(args.init_from, keep=1).restore_params(state)
        print(f"warm-started params from {args.init_from}")

    ckpt = None
    best_map, best_record, best_ckpt = float("-inf"), None, None
    if cfg.train.checkpoint_dir:
        ckpt = CheckpointManager(cfg.train.checkpoint_dir,
                                 cfg.train.keep_checkpoints, config=cfg)
        state = ckpt.restore(state)
        if ckpt.latest_step is not None:
            print(f"restored checkpoint at step {ckpt.latest_step}")
        # The fully resolved config beside the checkpoints.
        if writer:
            with open(os.path.join(cfg.train.checkpoint_dir, "config.json"),
                      "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=2,
                          sort_keys=True)
        # Resume-safe best tracking: a restarted run's first eval must beat
        # the best so far, not -inf.
        best_record = os.path.join(cfg.train.checkpoint_dir, "best",
                                   "best_map.json")
        if os.path.exists(best_record):
            with open(best_record) as f:
                best_map = float(json.load(f)["mAP"])
            print(f"resumed best-mAP tracker: {best_map:.4f}")

    dataset = build_dataset(cfg, split="train")
    print(f"dataset: {cfg.data.dataset}, {len(dataset)} examples")
    loader = DataLoader(cfg, dataset, cfg.train.batch_size, shuffle=True,
                        seed=cfg.train.seed, augment=True,
                        process_index=dp.rank if dp else None,
                        process_count=dp.world_size if dp else None)
    step_fn = make_train_step(model, cfg, device=device,
                              fused_preprocess=True, dp=dp)
    logger = MetricsLogger((args.logdir or None) if writer else None)

    def save(manager, **kw):
        """Rank 0 writes (its model peers lend their shards); every rank
        waits until it has."""
        if dp is None or dp.rank == 0:
            manager.save(state, **kw)
        if dp is not None:
            dp.barrier()

    start = state.step
    eval_dataset = eval_step_fn = None
    stream = loader.device_stream(device)
    t_first = None
    for step in range(start, cfg.train.total_steps):
        batch = next(stream)
        state, metrics = step_fn(state, batch)
        if args.debug_nans:
            bad = {k: float(v) for k, v in metrics.items()
                   if not math.isfinite(float(v))}
            if bad:
                raise FloatingPointError(f"step {step + 1}: non-finite {bad}")
        if writer and ((step + 1) % cfg.train.log_every == 0
                       or step == start):
            logger.log(step + 1, metrics)
        if step == start:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t_first = time.perf_counter()
        if (writer and args.log_images_every
                and (step + 1) % args.log_images_every == 0):
            from tpudet_torch.eval.visualize import draw_detections

            gtv = batch["gt_valid"][0].cpu().numpy()
            drawn = draw_detections(batch["image"][0].cpu().numpy(),
                                    batch["gt_boxes"][0].cpu().numpy()[gtv],
                                    batch["gt_classes"][0].cpu().numpy()[gtv])
            logger.log_image(step + 1, "train/ground_truth", drawn)
        if ckpt and (step + 1) % cfg.train.checkpoint_every == 0:
            save(ckpt)
        if args.eval_every and (step + 1) % args.eval_every == 0:
            from tpudet_torch.cli.eval import evaluate

            if eval_dataset is None:
                eval_dataset = build_dataset(cfg, split="val")
                # Built once and reused at every interval.
                eval_step_fn = make_eval_step(model, cfg, fused_preprocess=True)
            summary = evaluate(cfg, model, eval_dataset,
                               batch_size=min(8, cfg.train.batch_size),
                               max_images=args.eval_max_images, verbose=False,
                               eval_step=eval_step_fn)
            if writer:
                logger.log(step + 1, {"mAP": summary["mAP"]}, prefix="eval")
            if ckpt and summary["mAP"] > best_map:
                # The best checkpoint by in-training mAP (the deploy
                # artifact) under <checkpoint_dir>/best; the newest stays
                # the resume artifact.
                best_map = summary["mAP"]
                if best_ckpt is None:
                    best_ckpt = CheckpointManager(
                        os.path.join(cfg.train.checkpoint_dir, "best"),
                        keep=1, config=cfg)
                save(best_ckpt, force=True)
                if writer:
                    with open(best_record, "w") as f:
                        json.dump({"mAP": best_map, "step": step + 1}, f)
                    print(f"new best mAP {best_map:.4f} at step {step + 1} "
                          "-> checkpointed to best/")
    stream.close()
    if ckpt:
        save(ckpt, force=True)
    logger.close()
    if t_first is not None and state.step - start > 1:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t_first
        n = state.step - start - 1
        print(f"training done: steps {start + 1}..{state.step}, "
              f"{n * cfg.train.batch_size / seconds:.1f} img/s (global "
              "batch) over the "
              f"{n} steps after the first ({seconds:.2f} s of wall time, "
              "evals and checkpoints included)")
    else:
        print("training done.")
    return state


if __name__ == "__main__":
    main()
