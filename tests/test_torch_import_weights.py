"""``from_flax_variables`` on the trees of both families: the 3-D
``DenseGeneral`` kernels of Flax attention, LayerNorm scales and the bare
embedding parameters of Deformable DETR, Faster R-CNN trees mapped
exactly as before those rules existed, and the transposed convolutions of
ViTDet's simple feature pyramid (flipped, as the mask head's)."""

import dataclasses

import flax
import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from tpudet import config as jconfig
from tpudet.cli.common import preset_config as jax_preset
from tpudet.models import build_model as jax_build_model
from tpudet_torch.cli.common import preset_config
from tpudet_torch.models import build_model
from tpudet_torch.models.detr import MultiHeadDotProductAttention
from tpudet_torch.models.import_weights import from_flax_variables

torch.set_num_threads(2)


def numpy_tree(variables):
    return flax.core.unfreeze(jax.tree_util.tree_map(np.asarray, variables))


def test_attention_kernels_map_to_flattened_heads():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 7, 32)).astype(np.float32)
    kv = rng.normal(0, 1, (2, 5, 32)).astype(np.float32)
    jm = fnn.MultiHeadDotProductAttention(num_heads=4, qkv_features=32)
    v = numpy_tree(jm.init(jax.random.key(0), x, kv, kv))
    v = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), v)
    p = v["params"]
    assert p["query"]["kernel"].shape == (32, 4, 8)
    assert p["query"]["bias"].shape == (4, 8)
    assert p["out"]["kernel"].shape == (4, 8, 32)
    sd = from_flax_variables(v)
    np.testing.assert_array_equal(sd["query.weight"].numpy(),
                                  p["query"]["kernel"].reshape(32, 32).T)
    np.testing.assert_array_equal(sd["value.bias"].numpy(),
                                  p["value"]["bias"].reshape(32))
    np.testing.assert_array_equal(sd["out.weight"].numpy(),
                                  p["out"]["kernel"].reshape(32, 32).T)
    tm = MultiHeadDotProductAttention(32, 4, torch.float32)
    tm.load_state_dict(sd)  # strict
    ref = np.asarray(jm.apply(v, x, kv, kv))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(kv),
                 torch.from_numpy(kv))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_layer_norm_scale_and_embeddings_map():
    tree = {"params": {
        "dec0": {"norm1": {"scale": np.full(4, 2.0, np.float32),
                           "bias": np.ones(4, np.float32)}},
        "input_norm0": {"scale": np.full(4, 3.0, np.float32)},
        "backbone": {"AdaptiveGroupNorm_0": {"GroupNorm_0": {
            "scale": np.full(4, 5.0, np.float32)}}},
        "level_embed": np.arange(8, dtype=np.float32).reshape(2, 4),
    }, "constants": {"backbone": {"norm1": {
        "scale": np.full(4, 7.0, np.float32)}}}}
    sd = from_flax_variables(tree)
    assert set(sd) == {"dec0.norm1.weight", "dec0.norm1.bias",
                       "input_norm0.weight", "backbone.AdaptiveGroupNorm_0.scale",
                       "level_embed", "backbone.norm1.scale"}
    assert (sd["dec0.norm1.weight"] == 2).all()
    assert (sd["backbone.norm1.scale"] == 7).all()  # a FrozenBN buffer
    np.testing.assert_array_equal(sd["level_embed"].numpy(),
                                  tree["params"]["level_embed"])


def first_rule(variables):
    """The mapping for Faster R-CNN trees: GroupNorm_0 dropped, conv kernels
    HWIO -> OIHW, every other kernel transposed, the rest unchanged."""
    out = {}
    for collection in ("params", "constants"):
        flat = flax.traverse_util.flatten_dict(variables.get(collection, {}))
        for path, leaf in flat.items():
            path = tuple(p for p in path if p != "GroupNorm_0")
            arr = np.asarray(leaf, np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
                path = path[:-1] + ("weight",)
            out[".".join(path)] = arr
    return out


@pytest.mark.parametrize("name", ["tiny", "tiny_fpn", "tiny_frozen_bn"])
def test_faster_rcnn_trees_map_as_before(name):
    cfg = jconfig.tiny_test_config(use_fpn=name == "tiny_fpn")
    if name == "tiny_frozen_bn":
        cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                       norm="frozen_bn"))
    v = numpy_tree(jax.jit(jax_build_model(cfg).init)(jax.random.key(0)))
    sd = from_flax_variables(v)
    want = first_rule(v)
    assert set(sd) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(sd[key].numpy(), arr)


def test_full_preset_tree_loads_by_name():
    """Every parameter of ``coco_deformable_detr_r50`` (ResNet-50, 6+6
    layers, per-layer heads) maps onto the port's model, names and shapes,
    strictly."""
    jm = jax_build_model(jax_preset("coco_deformable_detr_r50"))
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), flax.core.unfreeze(shapes))
    model = build_model(preset_config("coco_deformable_detr_r50"),
                        device="cpu")
    model.core.load_state_dict(from_flax_variables(zeros))  # strict
    assert model.core.dec5.self_attn.out.weight.shape == (256, 256)
    assert hasattr(model.core, "class_head5") and hasattr(model.core,
                                                          "bbox_head5")


@pytest.mark.parametrize("name", ["coco_cascade_r50_fpn",
                                  "coco_keypoint_r50_fpn",
                                  "coco_panoptic_r50_fpn",
                                  "coco_retinanet_r50", "coco_fcos_r50",
                                  "coco_detr_r50", "coco_vitdet_b",
                                  "voc_vgg16"])
def test_family_preset_trees_load_by_name(name):
    """Every parameter of the families' full presets (the cascade's
    det_head2/3, the 8x512 keypoint head and its 4x4 deconv, the mask and
    semantic heads with their GroupNorm scales; RetinaNet's and FCOS's
    level-agnostic heads, FCOS's GroupNorm towers and bare ``level_scales``;
    DETR's attention kernels and bare ``query_embed``) maps onto the port's
    model, names and shapes, strictly (no key left over either way), and
    ``flax_param_ndims`` gives each the ndim of its Flax leaf (the decay
    mask's: ``level_scales`` is 1-D and not decayed, the attention's
    flattened kernels and biases are 3-D and 2-D in Flax)."""
    from tpudet_torch.models.import_weights import flax_param_ndims

    jm = jax_build_model(jax_preset(name))
    shapes = flax.core.unfreeze(jax.eval_shape(jm.init, jax.random.key(0)))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    model = build_model(preset_config(name), device="cpu")
    sd = from_flax_variables(zeros)
    assert set(sd) == set(model.core.state_dict())
    model.core.load_state_dict(sd)  # strict: names and shapes
    # Each Flax leaf converted alone names its port parameter.
    want = {}
    for path, leaf in flax.traverse_util.flatten_dict(
            zeros["params"]).items():
        (key,) = from_flax_variables({"params": flax.traverse_util
                                      .unflatten_dict({path: leaf})})
        want[key] = leaf.ndim
    assert flax_param_ndims(model.core) == want
    core = model.core
    if name == "coco_keypoint_r50_fpn":
        assert core.keypoint_head.deconv.weight.shape == (512, 17, 4, 4)
    if name == "coco_panoptic_r50_fpn":
        assert core.semantic_head.p5_gn2.weight.shape == (128,)
        assert core.semantic_head.predict.weight.shape == (133, 128, 1, 1)
    if name == "coco_retinanet_r50":
        assert core.head.cls_logits.weight.shape == (9 * 80, 256, 3, 3)
    if name == "coco_fcos_r50":
        assert want["level_scales"] == 1 and core.head.box_gn3.weight.shape \
            == (256,)
    if name == "coco_detr_r50":
        assert want["dec5.cross_attn.query.weight"] == 3
        assert want["query_embed"] == 2
        assert core.dec5.cross_attn.out.weight.shape == (256, 256)
    if name == "coco_vitdet_b":
        assert want["backbone.pos_embed"] == 4
        assert core.backbone.pos_embed.shape == (1, 64, 64, 768)
        assert core.fpn.up4_deconv2.weight.shape == (384, 192, 2, 2)
    if name == "voc_vgg16":
        assert core.backbone.stage5.conv5_3.weight.shape == (512, 512, 3, 3)
        assert core.det_head.fc1.weight.shape == (4096, 7 * 7 * 256)


def test_simple_feature_pyramid_deconvs_load_flipped():
    """tpudet's ``SimpleFeaturePyramid`` with random weights on a random
    plain map: the port's p2 and p3, which go through the three 2x2
    stride-2 ``ConvTranspose`` layers (``up4_deconv1``, ``up4_deconv2``,
    ``up2_deconv``), within 1e-5 of tpudet's. Flax applies those kernels
    unflipped: loaded without the flip, each output 2x2 cell comes out
    permuted."""
    from tpudet.models.vit import SimpleFeaturePyramid as JaxSFP
    from tpudet_torch.models.import_weights import CONV_TRANSPOSE_LAYERS
    from tpudet_torch.models.vit import SimpleFeaturePyramid

    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 6, 8, 32)).astype(np.float32)
    jsfp = JaxSFP(channels=16)
    v = numpy_tree(jax.jit(jsfp.init)(jax.random.key(2), {"plain": x}))
    v = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.3, a.shape).astype(np.float32), v)
    ref = jax.jit(jsfp.apply)(v, {"plain": x})
    sfp = SimpleFeaturePyramid(32, channels=16)
    sfp.load_state_dict(from_flax_variables(v))  # strict
    with torch.no_grad():
        out = sfp({"plain": torch.from_numpy(x)})
    assert {"up4_deconv1", "up4_deconv2", "up2_deconv",
            "deconv"} <= CONV_TRANSPOSE_LAYERS
    for name in ("p2", "p3", "p4", "p5", "p6"):
        want = np.asarray(ref[name])
        np.testing.assert_allclose(out[name].permute(0, 2, 3, 1).numpy(),
                                   want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
