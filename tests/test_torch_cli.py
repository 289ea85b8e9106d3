"""The port's CLIs on the CPU (``--device cpu``): train, resume, the
training modes, eval and detect on ``--preset tiny --dataset synthetic``;
Mask R-CNN's train, eval (segm mAP, RLE segmentations in ``--save-json``)
and detect on ``--preset maskrcnn_tiny``; train, eval and detect on
``cascade_tiny``, ``keypoint_tiny`` (kp/ metrics, keypoints in
``--save-json`` and the drawing) and ``panoptic_tiny`` (panoptic/ metrics);
and the port's ``evaluate`` against the JAX package's on 8 synthetic val
images with the same weights (``from_flax_variables``): the same
detections per image (as ``tests/test_torch_faster_rcnn.py`` holds them)
and mAP within 1e-3."""

import csv
import json

import jax
import numpy as np
import pytest
import torch

from tpudet_torch.cli import detect as tdetect
from tpudet_torch.cli import eval as teval
from tpudet_torch.cli import train as ttrain

torch.set_num_threads(2)

TINY = ["--preset", "tiny", "--dataset", "synthetic", "--device", "cpu"]


def test_train_resume_eval_detect(tmp_path, capsys):
    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    state = ttrain.main(TINY + [
        "--steps", "3", "--batch-size", "2", "--checkpoint-dir", str(ckpt),
        "--logdir", str(logs), "--set", "train.checkpoint_every=2",
        "--set", "train.log_every=1", "--eval-every", "3",
        "--eval-max-images", "4", "--log-images-every", "3"])
    assert state.step == 3
    out = capsys.readouterr().out
    assert "[train step 3]" in out and "[eval step 3] mAP=" in out
    assert sorted(p.name for p in ckpt.iterdir()) == ["2", "3", "best",
                                                      "config.json"]
    best = json.loads((ckpt / "best" / "best_map.json").read_text())
    assert best["step"] == 3 and 0.0 <= best["mAP"] <= 1.0
    rows = list(csv.DictReader(open(logs / "metrics.csv")))
    assert [r["step"] for r in rows] == ["1", "2", "3", "3"]
    assert all(np.isfinite(float(r["loss"])) for r in rows[:3])
    assert (logs / "images" / "train_ground_truth_3.npy").exists()
    assert json.loads((ckpt / "config.json").read_text())["data"][
        "dataset"] == "synthetic"

    # Resumed: from step 3 to 5, the best-mAP record read back.
    state = ttrain.main(TINY + [
        "--steps", "5", "--batch-size", "2", "--checkpoint-dir", str(ckpt),
        "--set", "train.checkpoint_every=2"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 3" in out
    assert "resumed best-mAP tracker" in out
    assert "steps 4..5" in out and state.step == 5

    summary = teval.main(TINY + ["--checkpoint-dir", str(ckpt),
                                 "--batch-size", "4", "--max-images", "8",
                                 "--save-json", str(tmp_path / "r.json")])
    out = capsys.readouterr().out
    assert "restored step 5" in out
    assert "final NMS over 192 (box, class) candidates per image" in out
    assert 0.0 <= summary["mAP"] <= 1.0
    results = json.loads((tmp_path / "r.json").read_text())
    assert results and set(results[0]) == {"image_id", "category_id", "bbox",
                                           "score"}
    recall = teval.main(TINY + ["--checkpoint-dir", str(ckpt),
                                "--max-images", "4", "--metric",
                                "proposal-recall"])
    assert "recall@100_iou0.5" in recall

    from PIL import Image

    from tpudet_torch.data.synthetic import SyntheticDataset

    image = SyntheticDataset(3, image_size=200).get_example(2)["image"]
    Image.fromarray(image[:150]).save(tmp_path / "in.png")
    boxes, scores, classes = tdetect.main(TINY + [
        "--checkpoint-dir", str(ckpt), "--image", str(tmp_path / "in.png"),
        "--output", str(tmp_path / "out.png"), "--score-thresh", "0.0"])
    assert (tmp_path / "out.png").exists() and len(boxes)
    assert (boxes[:, [0, 2]] <= 200).all() and (boxes[:, [1, 3]] <= 150).all()
    assert (boxes >= 0).all() and ((classes >= 1) & (classes <= 3)).all()


def test_maskrcnn_train_eval_save_json_detect(tmp_path, capsys):
    from PIL import Image

    from tpudet_torch.data.masks import rle_decode

    mask = ["--preset", "maskrcnn_tiny", "--dataset", "synthetic",
            "--device", "cpu"]
    ckpt = tmp_path / "ckpt"
    ttrain.main(mask + ["--steps", "2", "--batch-size", "2",
                        "--checkpoint-dir", str(ckpt),
                        "--set", "train.log_every=1"])
    out = capsys.readouterr().out
    assert "mask_loss=" in out and "[train step 2]" in out
    saved = tmp_path / "dets.json"
    summary = teval.main(mask + ["--checkpoint-dir", str(ckpt),
                                 "--max-images", "4", "--batch-size", "2",
                                 "--save-json", str(saved)])
    out = capsys.readouterr().out
    assert "segm/mAP" in summary and "segm/mAP: " in out
    assert 0.0 <= summary["segm/mAP"] <= 1.0
    records = json.loads(saved.read_text())
    assert records and all(isinstance(r["segmentation"]["counts"], str)
                           for r in records)
    first = records[0]["segmentation"]
    assert rle_decode(first).shape == tuple(first["size"])
    image = tmp_path / "x.png"
    Image.fromarray(np.full((96, 128, 3), 90, np.uint8)).save(image)
    tdetect.main(mask + ["--checkpoint-dir", str(ckpt), "--image",
                         str(image), "--output", str(tmp_path / "o.png"),
                         "--score-thresh", "0.0"])
    assert (tmp_path / "o.png").exists()


@pytest.mark.parametrize("preset,loss,metric", [
    ("cascade_tiny", "det_cls_loss_s3=", "mAP"),
    ("keypoint_tiny", "keypoint_loss=", "kp/mAP"),
    ("panoptic_tiny", "semantic_loss=", "panoptic/PQ")])
def test_family_train_eval_detect(tmp_path, capsys, preset, loss, metric):
    from PIL import Image

    argv = ["--preset", preset, "--dataset", "synthetic", "--device", "cpu"]
    ckpt = tmp_path / "ckpt"
    state = ttrain.main(argv + ["--steps", "2", "--batch-size", "2",
                                "--checkpoint-dir", str(ckpt),
                                "--set", "train.log_every=1"])
    out = capsys.readouterr().out
    assert state.step == 2 and loss in out and "[train step 2]" in out
    saved = tmp_path / "dets.json"
    summary = teval.main(argv + ["--checkpoint-dir", str(ckpt),
                                 "--max-images", "4", "--batch-size", "2",
                                 "--save-json", str(saved)])
    out = capsys.readouterr().out
    assert f"{metric}: " in out
    # Per-class APs of classes without ground truth are NaN by design.
    assert all(np.isfinite(v) for k, v in summary.items()
               if "/class_" not in k)
    records = json.loads(saved.read_text())
    if preset == "keypoint_tiny":
        assert {"kp/mAP", "kp/mAP@0.5"} <= set(summary)
        assert records and all(len(r["keypoints"]) == 15 for r in records)
    if preset == "panoptic_tiny":
        assert {"panoptic/PQ", "panoptic/SQ", "panoptic/RQ",
                "panoptic/semantic_mIoU", "segm/mAP"} <= set(summary)
        assert summary["panoptic/semantic_mIoU"] > 0
    image = tmp_path / "x.png"
    Image.fromarray(np.full((96, 128, 3), 90, np.uint8)).save(image)
    boxes, _, _ = tdetect.main(argv + [
        "--checkpoint-dir", str(ckpt), "--image", str(image), "--output",
        str(tmp_path / "o.png"), "--score-thresh", "0.0"])
    assert (tmp_path / "o.png").exists() and len(boxes) > 0


def test_training_modes(tmp_path, capsys):
    stage1 = tmp_path / "rpn"
    ttrain.main(TINY + ["--steps", "2", "--batch-size", "2", "--rpn-only",
                        "--checkpoint-dir", str(stage1)])
    out = capsys.readouterr().out
    assert "rpn_cls_loss" in out and "det_cls_loss" not in out
    state = ttrain.main(TINY + ["--steps", "2", "--batch-size", "2",
                                "--det-only", "--init-from", str(stage1),
                                "--freeze", "backbone"])
    out = capsys.readouterr().out
    assert "warm-started params" in out and "det_cls_loss" in out
    assert "rpn_cls_loss" not in out.split("warm-started params")[1]
    assert state.step == 2
    # Once refused: pretrained backbone weights (tpudet's tiny backbone
    # through the npz format both packages write) and the flipped eval.
    from tpudet import config as jconfig
    from tpudet.models import FasterRCNN as JaxFasterRCNN
    from tpudet_torch.models.import_weights import save_backbone_npz

    v = jax.jit(JaxFasterRCNN(jconfig.tiny_test_config()).init)(
        jax.random.key(1))
    weights = tmp_path / "w.npz"
    save_backbone_npz(str(weights), jax.tree_util.tree_map(
        np.asarray, v["params"]["backbone"]), {})
    state = ttrain.main(TINY + ["--steps", "1", "--batch-size", "2",
                                "--backbone-weights", str(weights),
                                "--checkpoint-dir", str(tmp_path / "bw")])
    assert "loaded backbone weights" in capsys.readouterr().out
    assert state.step == 1
    summary = teval.main(TINY + ["--tta", "hflip", "--max-images", "4",
                                 "--batch-size", "2", "--checkpoint-dir",
                                 str(tmp_path / "bw")])
    assert "mAP" in summary


def test_evaluate_equals_jax():
    """8 synthetic val images through each package's ``evaluate`` under the
    referee config, with the tiny model's Flax weights (wide heads, random
    GN-free constants) carried across."""
    from tests.test_torch_faster_rcnn import random_variables

    from tpudet import config as jconfig
    from tpudet.cli import eval as jeval
    from tpudet.data import build_dataset as jbuild
    from tpudet.models import FasterRCNN as JaxFasterRCNN
    from tpudet_torch import config as tconfig
    from tpudet_torch.data import build_dataset
    from tpudet_torch.models import build_model
    from tpudet_torch.models.import_weights import from_flax_variables

    jcfg = jeval.referee_config(jconfig.tiny_test_config())
    tcfg = teval.referee_config(tconfig.tiny_test_config())
    jm = JaxFasterRCNN(jcfg)
    variables = random_variables(jm, seed=3)
    model = build_model(tcfg, device="cpu")
    model.core.load_state_dict(from_flax_variables(variables))

    def run(evaluate, *args, path):
        summary = evaluate(*args, batch_size=4, max_images=8, verbose=False,
                           save_json=str(path))
        per_image = {}
        for r in json.loads(path.read_text()):
            per_image.setdefault(r["image_id"], []).append(r)
        return summary, per_image

    import pathlib
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        ref_summary, ref = run(jeval.evaluate, jcfg, jm,
                               jax.tree_util.tree_map(np.asarray, variables),
                               jbuild(jcfg, "val"), path=tmp / "ref.json")
        port_summary, port = run(teval.evaluate, tcfg, model,
                                 build_dataset(tcfg, "val"),
                                 path=tmp / "port.json")
    assert sorted(port) == sorted(ref) and len(ref) == 8
    n = 0
    for image_id, dets in ref.items():
        got = list(port[image_id])
        assert len(got) == len(dets), image_id
        for d in dets:
            match = [g for g in got
                     if g["category_id"] == d["category_id"]
                     and abs(g["score"] - d["score"]) < 1e-4
                     and np.allclose(g["bbox"], d["bbox"], rtol=1e-4,
                                     atol=1e-3)]
            assert match, (image_id, d)
            got.remove(min(match, key=lambda g: abs(g["score"] - d["score"])))
            n += 1
    assert n >= 8 * 5
    assert set(port_summary) == set(ref_summary)
    for k in ref_summary:
        assert abs(port_summary[k] - ref_summary[k]) <= 1e-3, k
