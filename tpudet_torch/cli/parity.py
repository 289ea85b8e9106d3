"""One-command VOC mAP-parity run (``tpudet.cli.parity``): the north star's
"VOC mAP@0.5 parity with the TF2 reference +-0.3".

With a VOC 2007 tree and ImageNet backbone weights, this single command
runs the whole pipeline through the port:

    python -m tpudet_torch.cli.parity \\
        --data-dir /path/to/VOCdevkit/VOC2007 \\
        --backbone-weights r50_imagenet.npz \\
        --workdir /tmp/parity_voc

Stages (each resumable: a rerun restores from the checkpoint directory):
  1. check the VOC layout and that the backbone weights exist
  2. train the voc_r50 preset (default 80k steps, the SGD schedule of
     TrainConfig; --steps to override) with in-training eval
  3. evaluate VOC mAP@0.5 (the PASCAL devkit's protocol) on the test split
  4. print the parity table (per-class AP and mAP) to compare against the
     reference's numbers

The backbone .npz comes from the port's converters
(``tpudet_torch/models/import_weights.py``), from a torchvision or timm
state dict or a Keras model, with no TensorFlow import:

    python - <<'PY'
    import torchvision
    from tpudet_torch.models.import_weights import (convert_torch_resnet,
                                                    save_backbone_npz)
    m = torchvision.models.resnet50(weights="IMAGENET1K_V1")
    save_backbone_npz("r50_imagenet.npz", *convert_torch_resnet(
        m.state_dict()))
    PY

(a torchvision ResNet is the pytorch style: build with
--set backbone.stride_in_1x1=False; ``convert_keras_resnet`` takes
``tf.keras.applications.ResNet50(weights="imagenet", include_top=False)``.)

``--dry-run`` runs every stage end to end on synthetic data with a few
steps (no data or weights needed): the tests run it, so the command is
known to work before the data appears."""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="voc_r50",
                   choices=["voc_r50", "voc_vgg16"],
                   help="detector preset to train and evaluate (the "
                        "reference's backbone is Keras ResNet-50 or VGG-16: "
                        "run the one of the checkpoint being compared)")
    p.add_argument("--data-dir", default="",
                   help="VOC2007 root (holds JPEGImages/, Annotations/, "
                        "ImageSets/)")
    p.add_argument("--backbone-weights", default="",
                   help="ImageNet backbone .npz from "
                        "models.import_weights.save_backbone_npz")
    p.add_argument("--workdir", default="parity_voc",
                   help="checkpoints and logs land here; rerun to resume")
    p.add_argument("--steps", type=int, default=80000)
    p.add_argument("--batch-size", type=int, default=0,
                   help="global batch (default: the preset's)")
    p.add_argument("--eval-batch-size", type=int, default=8)
    p.add_argument("--train-split", default="trainval")
    p.add_argument("--eval-split", default="test")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   help="dotted config overrides forwarded to train and eval")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain versions of the kernels)")
    p.add_argument("--dry-run", action="store_true",
                   help="synthetic data, a few steps: proves the command end "
                        "to end without data or weights")
    args = p.parse_args(argv)

    from tpudet_torch.cli import eval as eval_cli
    from tpudet_torch.cli import train as train_cli

    os.makedirs(args.workdir, exist_ok=True)
    ckpt = os.path.join(args.workdir, "checkpoints")
    logdir = os.path.join(args.workdir, "logs")

    if args.dry_run:
        preset = ["--preset", "tiny", "--dataset", "synthetic"]
        steps = min(args.steps, 30)
        data = []
        splits_tr, splits_ev = [], []
    else:
        if not args.data_dir:
            p.error("--data-dir is required (or pass --dry-run)")
        preset = ["--preset", args.preset, "--dataset", "voc"]
        steps = args.steps
        data = ["--data-dir", args.data_dir]
        splits_tr = ["--set", f"data.split={args.train_split!r}"]
        splits_ev = ["--split", args.eval_split]
        # Stage 1: fail fast on layout or weight problems before training.
        for sub in ("JPEGImages", "Annotations", "ImageSets"):
            path = os.path.join(args.data_dir, sub)
            if not os.path.isdir(path):
                raise SystemExit(
                    f"parity: VOC layout check failed: missing {path}")
        if args.backbone_weights and not os.path.isfile(args.backbone_weights):
            raise SystemExit(
                f"parity: backbone weights not found: {args.backbone_weights}")
        if not args.backbone_weights:
            print("parity: WARNING: no --backbone-weights; training from "
                  "random init will NOT reach the reference's mAP")

    overrides = []
    for ov in args.overrides:
        overrides += ["--set", ov]
    device = ["--device", args.device]

    # Stage 2: train (restore-on-start makes this resumable).
    train_argv = (preset + data + splits_tr + overrides + device + [
        "--steps", str(steps),
        "--checkpoint-dir", ckpt,
        "--logdir", logdir,
        "--eval-every", str(max(steps // 8, 1)),
    ])
    if args.batch_size:
        train_argv += ["--batch-size", str(args.batch_size)]
    if args.backbone_weights:
        train_argv += ["--backbone-weights", args.backbone_weights]
    print(f"parity stage 2/4: train ({steps} steps) -> {ckpt}")
    train_cli.main(train_argv)

    # Stages 3 and 4: the protocol's VOC eval and the parity table.
    print("parity stage 3/4: evaluating", args.eval_split or "synthetic")
    eval_argv = (preset + data + splits_ev + overrides + device + [
        "--checkpoint-dir", ckpt,
        "--batch-size", str(args.eval_batch_size),
        "--metric", "voc",
    ])
    summary = eval_cli.main(eval_argv)

    print("parity stage 4/4: VOC2007 parity table (compare against the "
          "reference's published per-class table):")
    print(f"  {'class':<16} AP@0.5")
    for key in sorted(summary):
        if key.startswith("AP/"):
            print(f"  {key[3:]:<16} {summary[key]:.4f}")
    print(f"  {'mAP@0.5':<16} {summary.get('mAP', float('nan')):.4f}")
    print("parity: done; the north-star clause is |mAP - reference| <= 0.3")
    return summary


if __name__ == "__main__":
    main()
