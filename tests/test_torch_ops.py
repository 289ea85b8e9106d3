"""Box geometry, anchors and the preprocess of the PyTorch port against the
JAX package: the same numpy inputs through both, f32 ``atol 1e-5`` (the
operations are elementwise and in the same order; 1e-5 covers ``exp`` and
``log`` of the two libraries on coordinates of a few hundred pixels, as a
relative 1e-7)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpudet import config as jconfig
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.models import FasterRCNN as JaxFasterRCNN
from tpudet.ops import anchors as janchors
from tpudet.ops import boxes as jboxes
from tpudet_torch import config as tconfig
from tpudet_torch.cli.common import preset_config
from tpudet_torch.data.preprocess import device_preprocess
from tpudet_torch.models import build_model
from tpudet_torch.ops import anchors as tanchors
from tpudet_torch.ops import boxes as tboxes

torch.set_num_threads(2)
ATOL = 1e-5


def boxes_pair(seed, n=64, degenerate=True):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20, 300, (n, 2))
    wh = rng.uniform(0, 120, (n, 2))
    b = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    if degenerate:
        b[:4, 2] = b[:4, 0] - 3.0  # inverted: area 0
    return b


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=1e-6,
                               atol=atol)


def test_area_and_pairwise_iou():
    a, b = boxes_pair(0), boxes_pair(1, n=40)
    close(tboxes.area(torch.from_numpy(a)), jboxes.area(jnp.asarray(a)),
          atol=1e-2)  # areas up to 1.4e4 px^2
    close(tboxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)),
          jboxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0),
                                     (10.0, 10.0, 5.0, 5.0)])
def test_encode_decode_equal_jax(weights):
    anchors = boxes_pair(2, degenerate=False)
    targets = boxes_pair(3, degenerate=False)
    close(tboxes.encode_boxes(torch.from_numpy(targets),
                              torch.from_numpy(anchors), weights),
          jboxes.encode_boxes(jnp.asarray(targets), jnp.asarray(anchors),
                              weights))
    deltas = np.random.default_rng(4).normal(0, 1, (64, 4)).astype(np.float32)
    deltas[:3, 2:] = 9.0 * np.array(weights[2:], np.float32)  # past the clip
    dec = tboxes.decode_boxes(torch.from_numpy(deltas),
                              torch.from_numpy(anchors), weights)
    ref = jboxes.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors),
                              weights)
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-3)  # clipped boxes reach ~1e4 px
    assert tboxes.BBOX_XFORM_CLIP == jboxes.BBOX_XFORM_CLIP


def test_clip_boxes_batched_equals_per_image_jax():
    b = np.stack([boxes_pair(5), boxes_pair(6)])
    hw = np.array([[128.0, 200.0], [300.0, 90.0]], np.float32)
    out = tboxes.clip_boxes(torch.from_numpy(b), torch.from_numpy(hw)[:, None])
    for i in range(2):
        close(out[i], jboxes.clip_boxes(jnp.asarray(b[i]), jnp.asarray(hw[i])))


def test_anchor_grids_equal_jax():
    close(tanchors.base_anchors_np((32.0, 64.0), (0.5, 1.0, 2.0)),
          janchors.base_anchors_np((32.0, 64.0), (0.5, 1.0, 2.0)))
    close(tanchors.generate_anchors_np(5, 7, 16, (128.0, 256.0, 512.0),
                                       (0.5, 1.0, 2.0)),
          janchors.generate_anchors_np(5, 7, 16, (128.0, 256.0, 512.0),
                                       (0.5, 1.0, 2.0)))


@pytest.mark.parametrize("canvas_hw", [(640, 1024), (100, 72)])
def test_model_anchor_boxes_ceil_grid(canvas_hw):
    # Canvases not divisible by the stride use ceil(h / 16) cells.
    jm = JaxFasterRCNN(preset_jax("voc_r50"))
    tm = build_model(preset_config("voc_r50"), device="cpu")
    ref = np.asarray(jm.anchor_boxes(canvas_hw))
    out = tm.anchor_boxes(canvas_hw)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    close(out, ref)


def preset_jax(name):
    from tpudet.cli.common import preset_config as jax_preset

    return jax_preset(name)


# Fields of the port's config that the JAX package has not, as
# ``group.field``: ``vit_rel_pos`` turns on ViTDet's relative positions,
# which tpudet's ViT lacks. A preset the two packages share holds each at
# its default.
PORT_ONLY_FIELDS = {"backbone.vit_rel_pos"}


def assert_group_equals_jax(port, ref, group, where=""):
    """Every field of the port's ``group`` equals the JAX config's, and
    each of ``PORT_ONLY_FIELDS`` is at its default."""
    for f in dataclasses.fields(getattr(port, group)):
        got = getattr(getattr(port, group), f.name)
        if f"{group}.{f.name}" in PORT_ONLY_FIELDS:
            assert got == f.default, f"{where}{group}.{f.name}"
            continue
        assert got == getattr(getattr(ref, group), f.name), \
            f"{where}{group}.{f.name}"


def assert_preset_equals_jax(name):
    """Every field the port's config has equals the JAX preset's, but the
    port's own fields, which keep their defaults."""
    port, ref = preset_config(name), preset_jax(name)
    assert port.model == ref.model
    for group in ("data", "backbone", "anchors", "rpn", "roi", "retinanet",
                  "fcos", "detr", "deformable_detr", "train"):
        assert_group_equals_jax(port, ref, group)
    assert port.use_pallas == ref.use_pallas and port.rpn_only == ref.rpn_only


def test_voc_r50_preset_equals_jax():
    assert_preset_equals_jax("voc_r50")
    assert_preset_equals_jax("coco_r101_fpn")
    assert_preset_equals_jax("coco_maskrcnn_r50_fpn")  # Mask R-CNN
    assert_preset_equals_jax("coco_cascade_r50_fpn")  # Cascade R-CNN
    assert_preset_equals_jax("coco_vitdet_b")  # ViTDet, once still to port
    assert_preset_equals_jax("voc_vgg16")
    with pytest.raises(ValueError, match="unknown preset"):
        preset_config("coco_vitdet_l")


def test_deformable_detr_presets_equal_jax():
    assert_preset_equals_jax("coco_deformable_detr_r50")
    assert_preset_equals_jax("deformable_detr_tiny")
    d = preset_config("coco_deformable_detr_r50").deformable_detr
    assert (d.d_model, d.num_heads, d.enc_layers, d.dec_layers, d.ffn_dim,
            d.num_queries, d.num_levels, d.num_points) == (
                256, 8, 6, 6, 1024, 300, 4, 4)
    assert d.with_box_refine and d.sampling_gather == "mxu"


def test_cxcywh_conversions_equal_jax():
    b = boxes_pair(9)
    for name in ("xyxy_to_cxcywh", "cxcywh_to_xyxy"):
        ref = getattr(jboxes, name)(jnp.asarray(b))
        close(getattr(tboxes, name)(torch.from_numpy(b)), ref)
    back = tboxes.cxcywh_to_xyxy(tboxes.xyxy_to_cxcywh(torch.from_numpy(b)))
    close(back, b, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_preprocess_equals_jax(dtype):
    jcfg = jconfig.tiny_test_config()
    jcfg = jcfg.replace(backbone=dataclasses.replace(jcfg.backbone,
                                                     dtype=dtype))
    tcfg = tconfig.tiny_test_config()
    tcfg = tcfg.replace(backbone=dataclasses.replace(tcfg.backbone,
                                                     dtype=dtype))
    img = np.random.default_rng(7).integers(0, 256, (2, 16, 24, 3),
                                            dtype=np.uint8)
    hw = np.array([[16, 24], [12, 20]], np.float32)
    ref = jax_preprocess(jcfg, {"image": jnp.asarray(img),
                                "image_hw": jnp.asarray(hw)})
    out = device_preprocess(tcfg, {"image": torch.from_numpy(img),
                                   "image_hw": torch.from_numpy(hw)})
    assert str(out["image"].dtype).endswith(dtype)
    close(out["image"].float(), np.asarray(ref["image"], np.float32))
    close(out["image_hw"], ref["image_hw"])
    # Training needs the augmentation's draws (or a generator); given
    # them, tests/test_torch_data_preprocess.py holds it against JAX.
    with pytest.raises(ValueError, match="draws"):
        device_preprocess(tcfg, {"image": torch.from_numpy(img)},
                          training=True)
