"""The port's serving artifact with several canvases, and its loader in a
process of its own, on the CPU: aspect buckets route each image to its
canvas and return results in input order, each bucket's program equals the
live model at that canvas, orientation mode exports its two canvases, and
loading an artifact imports no model code (as ``tests/test_serving.py``
holds tpudet's). The tiny Faster R-CNN keeps 32 proposals before its NMS so
that the plain NMS's unrolled loop keeps the exported graphs small."""

import dataclasses
import json
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from tpudet_torch.config import apply_overrides, tiny_test_config
from tpudet_torch.data.preprocess import device_preprocess, prepare_example
from tpudet_torch.models import build_model
from tpudet_torch.serving import ServingModel, save_artifact

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"rpn.pre_nms_topk_test": 32, "rpn.post_nms_topk_test": 16,
         "roi.max_detections": 10}
BUCKETS = ((96, 96), (96, 128), (128, 96))


def small_config(**data):
    cfg = apply_overrides(tiny_test_config(), SMALL)
    return cfg.replace(data=dataclasses.replace(cfg.data, **data))


@pytest.fixture(scope="module")
def model():
    return build_model(small_config(), device="cpu").init(0)


@pytest.fixture(scope="module")
def bucketed(model, tmp_path_factory):
    cfg = small_config(aspect_buckets=BUCKETS, min_size=90, max_size=128)
    path = tmp_path_factory.mktemp("buckets") / "bucketed.tpudet"
    meta = save_artifact(str(path), cfg, model, 2, ["cpu"])
    return cfg, path, meta, ServingModel.load(str(path))


@pytest.fixture(scope="module")
def oriented(model, tmp_path_factory):
    cfg = small_config(orientation_buckets=True, canvas_short=64,
                       canvas_height=128, canvas_width=128, min_size=60,
                       max_size=128)
    path = tmp_path_factory.mktemp("orient") / "orient.tpudet"
    meta = save_artifact(str(path), cfg, model, 1, ["cpu"])
    return cfg, path, meta


def images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, hw + (3,), np.uint8)
            for hw in ((80, 80), (80, 128), (128, 80), (81, 81), (90, 150))]


def live(cfg, model, canvases, hw):
    with torch.no_grad():
        return model.predict(device_preprocess(
            cfg, {"image": torch.from_numpy(canvases),
                  "image_hw": torch.from_numpy(hw)}, training=False))


def test_bucketed_artifact_routes_by_aspect(bucketed):
    cfg, _, meta, serving = bucketed
    assert [tuple(b) for b in meta["buckets"]] == list(BUCKETS)
    assert set(serving.programs) == set(BUCKETS)
    imgs = images()
    results = serving.detect(imgs, score_thresh=0.0)
    assert len(results) == len(imgs)
    for img, det in zip(imgs, results):
        # In input order: each image's result is its own detect alone.
        alone = serving.detect([img], score_thresh=0.0)[0]
        for key in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(det[key], alone[key], err_msg=key)
        h, w = img.shape[:2]
        assert len(det["boxes"]) > 0
        assert (det["boxes"][:, 2] <= w + 1e-3).all()
        assert (det["boxes"][:, 3] <= h + 1e-3).all()


@pytest.mark.parametrize("index,canvas", [(0, (96, 96)), (1, (96, 128)),
                                          (2, (128, 96))])
def test_each_bucket_equals_the_live_model(bucketed, model, index, canvas):
    cfg, _, _, serving = bucketed
    p = prepare_example(serving._data_cfg, images()[index],
                        np.zeros((0, 4), np.float32), np.zeros(0, np.int32))
    assert p["image"].shape[:2] == canvas
    canvases = np.stack([p["image"], np.zeros_like(p["image"])])
    hw = np.stack([p["image_hw"], p["image_hw"]]).astype(np.float32)
    want = live(cfg, model, canvases, hw)
    got = serving(canvases, hw)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_orientation_buckets_export_two_canvases(oriented):
    _, path, meta = oriented
    assert [tuple(b) for b in meta["buckets"]] == [(64, 128), (128, 64)]
    # The loader test below runs this artifact in a process of its own.
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == ["metadata.json", "module_128x64.pt2",
                                         "module_64x128.pt2"]


LOADER = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(int(sys.argv[4]))
from tpudet_torch.serving import ServingModel
serving = ServingModel.load(sys.argv[1])
data = np.load(sys.argv[2])
out = serving(data["image"], data["hw"])
np.savez(sys.argv[3], **{k: v.numpy() for k, v in out.items()})
print(json.dumps(sorted(sys.modules)))
"""


def test_loader_imports_no_model_code(oriented, model, tmp_path):
    cfg, path, _ = oriented
    rng = np.random.default_rng(3)
    canvases = rng.integers(0, 255, (1, 64, 128, 3), np.uint8)
    hw = np.array([[60.0, 128.0]], np.float32)
    np.savez(tmp_path / "in.npz", image=canvases, hw=hw)
    proc = subprocess.run(
        [sys.executable, "-c", LOADER, str(path), str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz"), str(torch.get_num_threads())],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "tpudet_torch.serving" in loaded
    assert not [m for m in loaded if m.startswith("tpudet_torch.models")]
    assert not [m for m in loaded if m.split(".")[0] in (
        "jax", "flax", "optax", "orbax", "tpudet")]
    got = np.load(tmp_path / "out.npz")
    want = live(cfg, model, canvases, hw)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value.numpy(), err_msg=key)
