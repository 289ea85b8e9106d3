"""The port's serving path (``tpudet_torch/serving/export.py``) against the
JAX package's (``tpudet/serving/export.py``), on the CPU.

One tiny Faster R-CNN (``tiny_test_config(canvas=128, num_classes=3)``,
f32) in both packages with the same weights (``from_flax_variables``, head
kernels widened as ``tests/test_torch_faster_rcnn.py``'s ``HEAD_STD`` so
that real detections flow), each exported once into its artifact and
reused by every test here. Tolerances: boxes within 1e-3 px + 1e-4
relative, scores within 1e-5 (the two frameworks sum the convolutions in
other orders), classes exact; the port's artifact against the live port
exactly (the same program)."""

import json
import zipfile

import numpy as np
import pytest
import torch

from tests.test_torch_faster_rcnn import configs, pair
from tpudet.serving import ServingModel as JServingModel
from tpudet.serving import export as jexport
from tpudet_torch.data.preprocess import device_preprocess
from tpudet_torch.serving import ServingModel, export_model, save_artifact
from tpudet_torch.serving import export as texport

BATCH = 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, tcfg = configs("tiny")
    jm, variables, model = pair(jcfg, tcfg)
    work = tmp_path_factory.mktemp("serving")
    port_path, jax_path = work / "port.tpudet", work / "jax.tpudet"
    meta = save_artifact(str(port_path), tcfg, model, BATCH, ["cpu"])
    jmeta = jexport.save_artifact(str(jax_path), jcfg, variables, BATCH)
    return {"cfg": tcfg, "jcfg": jcfg, "model": model, "meta": meta,
            "jmeta": jmeta, "path": port_path, "jax_path": jax_path,
            "serving": ServingModel.load(str(port_path)),
            "jserving": JServingModel.load(str(jax_path))}


def mixed_images(seed=0):
    """Three images at non-canvas sizes and mixed aspects (the last batch
    is short and padded)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (100, 160, 3), np.uint8),
            rng.integers(0, 255, (160, 90, 3), np.uint8),
            rng.integers(0, 255, (128, 128, 3), np.uint8)]


def canvas_batch(seed=1):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 255, (BATCH, 128, 128, 3), np.uint8)
    hw = np.array([[128.0, 128.0], [96.0, 120.0]], np.float32)
    return image, hw


def test_detect_equals_jax(setup):
    images = mixed_images()
    got = setup["serving"].detect(images, score_thresh=0.0)
    want = setup["jserving"].detect(images, score_thresh=0.0)
    assert len(got) == len(want) == 3
    assert sum(len(w["boxes"]) for w in want) > 10
    for img, g, w in zip(images, got, want):
        assert set(g) == set(w) == {"boxes", "scores", "classes"}
        np.testing.assert_array_equal(g["classes"], w["classes"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=1e-4,
                                   atol=1e-3)
        h, wd = img.shape[:2]
        if len(g["boxes"]):
            assert (g["boxes"] >= 0).all()
            assert (g["boxes"][:, 2] <= wd + 1e-3).all()
            assert (g["boxes"][:, 3] <= h + 1e-3).all()
    # The default threshold is the config's.
    kept = setup["serving"].detect(images)
    for g, k in zip(got, kept):
        np.testing.assert_array_equal(k["scores"], g["scores"][
            g["scores"] >= setup["cfg"].roi.score_thresh])


def test_artifact_matches_live_model(setup):
    image, hw = canvas_batch()
    cfg, model = setup["cfg"], setup["model"]
    with torch.no_grad():
        want = model.predict(device_preprocess(
            cfg, {"image": torch.from_numpy(image),
                  "image_hw": torch.from_numpy(hw)}, training=False))
    got = setup["serving"](image, hw)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # The CPU program carries the plain versions: no tpudet:: operator.
    assert [texport.program_ops(p)
            for p in setup["serving"].programs.values()] == [[]]


def test_metadata_equals_jax(setup):
    meta, jmeta = setup["meta"], setup["jmeta"]
    assert set(meta) - {"kernels_embedded"} == set(jmeta) - {"pallas_embedded"}
    for key, value in jmeta.items():
        if key not in ("platforms", "pallas_embedded"):
            assert meta[key] == value, key
    assert meta["platforms"] == ["cpu"]
    # The CPU carries the plain versions: no tpudet:: operator.
    assert meta["kernels_embedded"] is False
    assert meta["artifact_version"] == texport.ARTIFACT_VERSION == 1
    assert meta == texport._serving_metadata(setup["cfg"], BATCH, ["cpu"],
                                             False)
    with zipfile.ZipFile(setup["path"]) as zf:
        names = sorted(i.filename for i in zf.infolist())
        assert names == ["metadata.json", "module_128x128.pt2"]
        assert all(i.compress_type == zipfile.ZIP_STORED
                   for i in zf.infolist())
        assert json.loads(zf.read("metadata.json")) == meta


def test_loader_refuses_other_versions(setup, tmp_path):
    bad = tmp_path / "v2.tpudet"
    with zipfile.ZipFile(setup["path"]) as src, \
            zipfile.ZipFile(bad, "w", zipfile.ZIP_STORED) as dst:
        for item in src.infolist():
            data = src.read(item.filename)
            if item.filename == "metadata.json":
                data = json.dumps({**json.loads(data), "artifact_version": 2})
            dst.writestr(item.filename, data)
    with pytest.raises(ValueError, match="artifact version 2"):
        texport.load_artifact(str(bad))


@pytest.mark.parametrize("platforms",
                         [["tpu"], ["cuda", "cpu"], ["tpu", "cpu"]],
                         ids=["foreign", "two", "foreign_and_cpu"])
def test_platforms_name_one_device(setup, platforms):
    with pytest.raises(ValueError, match="exactly one of"):
        texport.check_platforms(platforms)


def test_export_device_is_the_models(setup):
    with pytest.raises(ValueError, match="lives on cpu"):
        export_model(setup["cfg"], setup["model"], BATCH, ["cuda"])
