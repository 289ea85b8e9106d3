"""Test-time augmentation of the PyTorch port against ``tpudet``'s, on the
CPU: ``flip_batch`` on uint8 canvases with partly valid extents,
``unflip_detections`` with masks and keypoints (with and without flip
pairs), ``merge_detections`` on random candidate sets, ``tta_knobs`` per
family, and ``evaluate(tta="hflip")`` on ``tiny`` and ``keypoint_tiny``
against tpudet's with the same weights.

Tolerances: the flip, the unflip and the merge exactly equal (the same
arithmetic on the same arrays); the evaluation's detections as
``tests/test_torch_cli.py::test_evaluate_equals_jax`` holds them (scores
within 1e-4, boxes within 1e-3 px plus 1e-4 relative) and each metric
within 1e-3.
"""

import json
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet import config as jconfig
from tpudet.cli import eval as jeval
from tpudet.eval import tta as jtta
from tpudet_torch import config as tconfig
from tpudet_torch.cli import eval as teval
from tpudet_torch.eval import tta as ttta

torch.set_num_threads(2)


def detections(seed, b=2, d=12, classes=3, kps=0, masks=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 90, (b, d, 2))
    wh = rng.uniform(5, 40, (b, d, 2))
    out = {"boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
           "scores": rng.uniform(0, 1, (b, d)).astype(np.float32),
           "classes": rng.integers(1, classes + 1, (b, d)).astype(np.int32),
           "valid": rng.uniform(size=(b, d)) > 0.2}
    out["scores"][:, 3] = out["scores"][:, 4]  # a tie
    if kps:
        out["keypoints"] = rng.uniform(0, 120, (b, d, kps, 3)).astype(
            np.float32)
    if masks:
        out["masks"] = rng.uniform(0, 1, (b, d, masks, masks)).astype(
            np.float32)
    return out


def test_flip_batch_equals_jax():
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (3, 16, 24, 3), dtype=np.uint8)
    hw = np.array([[16, 24], [12, 17], [16, 1]], np.float32)
    ref = jtta.flip_batch({"image": jnp.asarray(image),
                           "image_hw": jnp.asarray(hw)})
    out = ttta.flip_batch({"image": torch.from_numpy(image),
                           "image_hw": torch.from_numpy(hw)})
    np.testing.assert_array_equal(out["image"].numpy(),
                                  np.asarray(ref["image"]))
    assert out["image_hw"] is not None
    # The padding stays; a second flip restores the canvas.
    np.testing.assert_array_equal(out["image"][1, :, 17:].numpy(),
                                  image[1, :, 17:])
    twice = ttta.flip_batch(out)["image"].numpy()
    np.testing.assert_array_equal(twice, image)


@pytest.mark.parametrize("pairs", [(), ((1, 2), (3, 4))])
def test_unflip_detections_equals_jax(pairs):
    det = detections(1, kps=5, masks=6)
    hw = np.array([[100, 120], [80, 96]], np.float32)
    ref = jtta.unflip_detections(det, hw, flip_pairs=pairs)
    out = ttta.unflip_detections(det, hw, flip_pairs=pairs)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_merge_detections_equals_jax(seed):
    a = detections(seed, kps=3, masks=4)
    b = jtta.unflip_detections(detections(seed + 10, kps=3, masks=4),
                               np.array([[100, 120], [80, 96]], np.float32))
    for i in range(2):
        for thresh, max_det in ((0.5, 100), (0.3, 5)):
            ref = jtta.merge_detections(a, b, i, thresh, max_det)
            out = ttta.merge_detections(a, b, i, thresh, max_det)
            assert set(out) == set(ref)
            for k in ref:
                np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    empty = {k: np.zeros_like(v) for k, v in a.items()}
    out = ttta.merge_detections(empty, empty, 0, 0.5, 10)
    assert all(len(v) == 0 for v in out.values())


@pytest.mark.parametrize("name", ["tiny_test_config", "tiny_retinanet_config",
                                  "tiny_fcos_config", "tiny_detr_config"])
def test_tta_knobs_equal_jax(name):
    ref = jeval._tta_knobs(getattr(jconfig, name)())
    assert ttta.tta_knobs(getattr(tconfig, name)()) == ref


@pytest.mark.parametrize("preset", ["tiny", "keypoint_tiny"])
def test_evaluate_with_hflip_equals_jax(preset):
    """``evaluate(tta="hflip")`` over 8 synthetic val images in both
    packages with the same weights: the same merged detections per image
    and the same metrics (keypoint_tiny: the keypoints unflip with the
    dataset's flip pairs)."""
    from tests.test_torch_faster_rcnn import random_variables
    from tpudet.cli.common import preset_config as jpreset
    from tpudet.data import build_dataset as jbuild
    from tpudet.models import build_model as jbuild_model
    from tpudet_torch.cli.common import preset_config
    from tpudet_torch.data import build_dataset
    from tpudet_torch.models import build_model
    from tpudet_torch.models.import_weights import from_flax_variables

    jcfg = jeval.referee_config(jpreset(preset))
    tcfg = teval.referee_config(preset_config(preset))
    jm = jbuild_model(jcfg)
    init = jax.jit(jm.init)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "init", init)
        variables = random_variables(jm, seed=3)
    model = build_model(tcfg, device="cpu")
    model.core.load_state_dict(from_flax_variables(variables))

    def run(evaluate, *args, path):
        summary = evaluate(*args, batch_size=4, max_images=8, verbose=False,
                           save_json=str(path), tta="hflip")
        per_image = {}
        for r in json.loads(path.read_text()):
            per_image.setdefault(r["image_id"], []).append(r)
        return summary, per_image

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
                                     atol=1e-3)
                     and np.allclose(g.get("keypoints", 0),
                                     d.get("keypoints", 0), rtol=1e-4,
                                     atol=1e-3)]
            assert match, (image_id, d)
            got.remove(min(match, key=lambda g: abs(g["score"] - d["score"])))
            n += 1
    assert n >= 8 * 5
    assert set(port_summary) == set(ref_summary)
    for k in ref_summary:
        assert abs(port_summary[k] - ref_summary[k]) <= 1e-3, k


def test_eval_cli_hflip_on_a_tiny_preset(tmp_path, capsys):
    argv = ["--preset", "tiny", "--dataset", "synthetic", "--device", "cpu"]
    from tpudet_torch.cli import train as ttrain

    ttrain.main(argv + ["--steps", "2", "--batch-size", "2",
                        "--checkpoint-dir", str(tmp_path / "ck")])
    summary = teval.main(argv + ["--tta", "hflip", "--max-images", "4",
                                 "--batch-size", "2", "--checkpoint-dir",
                                 str(tmp_path / "ck")])
    assert "mAP" in summary and "mAP: " in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown tta"):
        teval.evaluate(tconfig.tiny_test_config(), None, None, tta="vflip")
