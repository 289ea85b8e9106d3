"""Worker process of ``tests/test_torch_parallel.py``: one rank of a gloo
data-parallel group of the PyTorch port on the CPU (no JAX).

Each worker joins the group (``tpudet_torch.parallel.init_data_parallel``)
and, on its rows of the same global inputs:

* plans the loader's epoch over a bucketed dataset and loads its rows;
* takes one ``tiny`` Faster R-CNN train step, one ``deformable_detr_tiny``
  step and one ``detr_tiny`` step (dropout 0) through ``make_train_step``
  with the group, each in one batch and in two accumulated microbatches;
* saves a checkpoint from rank 0 behind a barrier, then restores it on
  every rank into a state drawn from another seed.

It writes what it saw to ``<out>/rank<r>.pt``; a failed assertion exits
non-zero, which fails the test.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL_BATCH = 4
# 19 images over the two buckets: each bucket ends in a padded tail.
SIZES = ([(60, 80), (80, 60), (64, 64), (70, 90), (90, 70)] * 4)[:19]


class SizedDataset:
    """Random images of ``SIZES`` with 0-3 boxes each (example_hw for the
    bucket plan)."""

    def __len__(self):
        return len(SIZES)

    def example_hw(self, i):
        return SIZES[i]

    def get_example(self, i):
        rng = np.random.default_rng([7, i])
        h, w = SIZES[i]
        n = int(rng.integers(0, 4))
        xy = rng.uniform(0, 0.6, (n, 2)) * (w, h)
        wh = rng.uniform(0.1, 0.4, (n, 2)) * (w, h)
        return {"image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                "boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
                "classes": rng.integers(1, 4, n).astype(np.int32)}


def loader_config():
    from tpudet_torch.config import apply_overrides, tiny_test_config

    return apply_overrides(tiny_test_config(), {
        "data.aspect_buckets": ((64, 96), (96, 64)),
        "data.min_size": 64, "data.max_size": 96})


def global_batch(cfg, seed):
    """The global batch of the step tests: normalized noise with 1-4
    planted boxes per image (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    b, h = GLOBAL_BATCH, cfg.data.canvas_height
    g = cfg.data.max_gt_boxes
    image = rng.normal(0, 1, (b, h, h, 3)).astype(np.float32)
    hw = np.tile(np.array([[h, h]], np.float32), (b, 1))
    hw[1] = (h * 0.75, h * 0.875)
    gt = np.zeros((b, g, 4), np.float32)
    classes = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i in range(b):
        k = int(rng.integers(1, 5))
        size = rng.uniform(0.15, 0.5, (k, 2)) * hw[i, ::-1]
        x1y1 = rng.uniform(0, 1, (k, 2)) * (hw[i, ::-1] - size)
        gt[i, :k] = np.concatenate([x1y1, x1y1 + size], -1)
        classes[i, :k] = rng.integers(1, cfg.data.num_classes + 1, k)
        valid[i, :k] = True
        for (x1, y1, x2, y2), c in zip(gt[i, :k].astype(int), classes[i, :k]):
            image[i, y1:y2, x1:x2] += c
    return {"image": image, "image_hw": hw, "gt_boxes": gt,
            "gt_classes": classes, "gt_valid": valid}


def step_configs():
    """The step tests' configs, each also with two accumulated
    microbatches."""
    from tpudet_torch.config import (
        apply_overrides,
        tiny_deformable_detr_config,
        tiny_detr_config,
        tiny_test_config,
    )

    configs = {"faster_rcnn": tiny_test_config(),
               "deformable_detr": tiny_deformable_detr_config(),
               "detr": tiny_detr_config()}
    for name, cfg in list(configs.items()):
        configs[name + "_accum2"] = apply_overrides(
            cfg, {"train.accum_steps": 2})
    return configs


def train_one(cfg, batch, dp=None):
    """One ``make_train_step`` step from the seed-0 state on ``batch``
    (this process's rows under ``dp``) -> metrics, gradients and the
    parameters after the update."""
    from tpudet_torch.models import build_model
    from tpudet_torch.train.state import create_train_state
    from tpudet_torch.train.step import make_train_step

    model = build_model(cfg, device="cpu")
    state = create_train_state(model, cfg.train, seed=0, device="cpu")
    step = make_train_step(model, cfg, device="cpu", dp=dp)
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    return state, {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {k: p.grad.detach().clone() for k, p in state.params.items()
                  if p.grad is not None},
        "params": {k: p.detach().clone() for k, p in state.params.items()}}


def fingerprint(state) -> float:
    return float(sum(p.detach().double().abs().sum()
                     for p in state.params.values()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from tpudet_torch.data import DataLoader
    from tpudet_torch.data.loader import process_rows
    from tpudet_torch.models import build_model
    from tpudet_torch.parallel import init_data_parallel
    from tpudet_torch.train.checkpoint import CheckpointManager
    from tpudet_torch.train.state import create_train_state

    dp = init_data_parallel("cpu", rank=args.rank, world_size=args.world,
                            init_method=args.init, timeout_s=90)
    result = {"rank": dp.rank}

    loader = DataLoader(loader_config(), SizedDataset(), GLOBAL_BATCH,
                        seed=3, num_workers=1, drop_last=False,
                        process_index=dp.rank, process_count=dp.world_size)
    result["loader"] = [
        {"index": b["example_index"].tolist(),
         "valid": b.get("batch_valid", np.ones(len(b["image"]),
                                               bool)).tolist(),
         "canvas": list(b["image"].shape[1:3]),
         "gt_boxes": b["gt_boxes"]} for b in loader.batches(1)]

    states = {}
    for name, cfg in step_configs().items():
        rows = process_rows(GLOBAL_BATCH, dp.rank, dp.world_size,
                            cfg.train.accum_steps)
        batch = {k: v[rows] for k, v in global_batch(cfg, seed=5).items()}
        states[name], result[name] = train_one(cfg, batch, dp)
    state = states["deformable_detr_accum2"]  # the checkpoint's

    # Rank 0 writes, every rank waits, then every rank restores into a
    # state drawn from another seed.
    ckpt_dir = os.path.join(args.out, "ckpt")
    if dp.rank == 0:
        CheckpointManager(ckpt_dir).save(state)
    dp.barrier()
    result["saved_fingerprint"] = fingerprint(state)
    cfg = step_configs()["deformable_detr"]
    fresh = create_train_state(build_model(cfg, device="cpu").init(123),
                               cfg.train, seed=123, device="cpu")
    assert fingerprint(fresh) != result["saved_fingerprint"]
    restored = CheckpointManager(ckpt_dir).restore(fresh)
    result["restored_step"] = restored.step
    result["restored_fingerprint"] = fingerprint(restored)
    torch.save(result, os.path.join(args.out, f"rank{dp.rank}.pt"))
    dp.barrier()
    dp.close()
    print(f"rank {args.rank}: done", flush=True)


if __name__ == "__main__":
    main()
