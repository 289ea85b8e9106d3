"""Every family of the port through the serving artifact on the CPU, as
tpudet's ``test_serving_export_roundtrip`` holds its eight: the tiny config
exported at b=1, written, loaded, and run on one seeded canvas equals the
live model's predict exactly (the same program on the same inputs). The
FPN families (FPN Faster R-CNN, ViTDet, Panoptic FPN) are in
``tests/test_torch_serving_families_{fpn,vitdet,panoptic}.py``.

Each config keeps few candidates before its NMS (the plain NMS's loop
unrolls in the exported graph) and a score threshold of 0, so that every
detection slot is valid and compared."""

import numpy as np
import pytest
import torch

from tpudet_torch import config as tconfig
from tpudet_torch.data.preprocess import device_preprocess
from tpudet_torch.models import build_model
from tpudet_torch.serving import ServingModel, save_artifact

SMALL = {"rpn.pre_nms_topk_test": 32, "rpn.post_nms_topk_test": 16,
         "rpn.fpn_pre_nms_topk_per_level_test": 16,
         "retinanet.pre_nms_topk": 16, "fcos.pre_nms_topk": 16,
         "roi.max_detections": 10, "retinanet.max_detections": 10,
         "fcos.max_detections": 10, "roi.score_thresh": 0.0,
         "retinanet.score_thresh": 0.0, "fcos.score_thresh": 0.0}

FAMILIES = {
    "cascade": tconfig.tiny_cascade_config,
    "deformable_detr": tconfig.tiny_deformable_detr_config,
    "detr": tconfig.tiny_detr_config,
    "fcos": tconfig.tiny_fcos_config,
    "keypoint": tconfig.tiny_keypoint_config,
    "mask_rcnn": tconfig.tiny_maskrcnn_config,
    "retinanet": tconfig.tiny_retinanet_config,
}


def roundtrip(make_config, tmp_path):
    """Export, save, load and run one tiny family against its live model ->
    the outputs' keys."""
    cfg = tconfig.apply_overrides(make_config(), SMALL)
    model = build_model(cfg, device="cpu").init(0)
    path = tmp_path / "family.tpudet"
    meta = save_artifact(str(path), cfg, model, 1, ["cpu"])
    assert meta["model"] == cfg.model and meta["kernels_embedded"] is False
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.integers(0, 256, (1, 128, 128, 3), np.uint8))
    hw = torch.tensor([[128.0, 100.0]])
    with torch.no_grad():
        want = model.predict(device_preprocess(
            cfg, {"image": image, "image_hw": hw}, training=False))
    got = ServingModel.load(str(path))(image, hw)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert int(want["num_detections"][0]) > 0
    return sorted(want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_serving_export_roundtrip(family, tmp_path):
    keys = roundtrip(FAMILIES[family], tmp_path)
    extra = {"keypoint": ["keypoints"], "mask_rcnn": ["masks"]}.get(family, [])
    assert keys == sorted(["boxes", "classes", "num_detections", "scores",
                           "valid", *extra])
