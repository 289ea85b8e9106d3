"""Model export CLI (``tpudet.cli.export``): trace the inference program
into a standalone serving artifact (``tpudet_torch/serving/export.py`` has
the artifact's contract).

Example, on the card (the Hopper kernels inside the exported graphs):
  python -m tpudet_torch.cli.export --preset voc_r50 --checkpoint-dir /ckpt \
      --batch-size 8 --output model.tpudet --verify
and on the CPU (the plain versions): add ``--platforms cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from tpudet_torch.cli.common import add_common_args, config_from_args
from tpudet_torch.models import build_model
from tpudet_torch.serving import ServingModel, save_artifact
from tpudet_torch.serving.export import check_platforms
from tpudet_torch.train.checkpoint import CheckpointManager
from tpudet_torch.train.state import create_train_state


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--output", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument(
        "--platforms", default="",
        help="the device the program is exported for and runs on: 'cuda' "
        "(the kernels inside) or 'cpu' (the plain versions); default: "
        "--device")
    p.add_argument(
        "--verify", action="store_true",
        help="reload the artifact and run one random 480x640 image through it")
    p.add_argument("--ema", action="store_true",
                   help="export the EMA average of the params")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    platforms = [s.strip() for s in args.platforms.split(",") if s.strip()]
    try:
        device = check_platforms(platforms) or args.device
    except ValueError as e:
        p.error(str(e))

    model = build_model(cfg, device=device)
    state = create_train_state(model, cfg.train, seed=cfg.train.seed,
                               device=device)
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir)
        if mgr.latest_step is None:
            # A valid-looking artifact of random weights is worse than a
            # failure: a mistyped path must not export.
            raise SystemExit(
                f"no checkpoint found in {args.checkpoint_dir!r}: refusing "
                "to export randomly initialized weights (omit "
                "--checkpoint-dir to export a random-weight smoke-test "
                "artifact)")
        state = mgr.restore_eval(state)
    else:
        print("WARNING: no --checkpoint-dir given: exporting RANDOMLY "
              "INITIALIZED weights (fine for smoke tests, useless for "
              "serving)")

    meta = save_artifact(args.output, cfg, state.eval_model(args.ema),
                         args.batch_size, [device])
    print(f"exported -> {args.output}")
    for k in ("batch_size", "canvas_height", "canvas_width", "num_classes",
              "max_detections", "platforms", "kernels_embedded"):
        print(f"  {k}: {meta[k]}")

    if args.verify:
        serving = ServingModel.load(args.output)
        rng = np.random.default_rng(0)
        img = rng.integers(0, 255, (480, 640, 3), np.uint8)
        dets = serving.detect([img], score_thresh=0.0)[0]
        print(f"verify: ok, {len(dets['boxes'])} detections on a random "
              "image")
    return meta


if __name__ == "__main__":
    main()
