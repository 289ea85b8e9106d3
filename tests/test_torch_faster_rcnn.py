"""Faster R-CNN inference of the PyTorch port against the JAX package, stage
by stage and as a whole, on the CPU.

Weights are made once in Flax (``FasterRCNN.init``), redrawn where the init
would hide a fault, and carried over with ``from_flax_variables``:

* FrozenBN constants are drawn at random (at init FrozenBN is the identity,
  which would hide a layout fault in the mapping);
* the objectness, cls and bbox kernels are drawn wider than Flax's
  ``normal(0.01)``/``normal(0.001)`` (std 0.1, 0.3 and 0.02 here). At init
  the softmax sits near 1/(C+1), below ``score_thresh=0.05``, and the final
  NMS would see no candidate; these widths spread the class scores over
  (0.05, 1) without saturating them, so real detections flow through both
  NMS calls.

Tolerances: float stages f32 ``rtol/atol 1e-4`` (the two frameworks sum the
ResNet-50 convolutions in other orders; the relative error at c4 is ~2e-6).
Stages fed the same inputs: exact valid masks, classes and NMS indices,
boxes to ``1e-4``.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet import config as jconfig
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.models import FasterRCNN as JaxFasterRCNN
from tpudet.models.faster_rcnn import DetectorCore as JaxCore
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.train.step import make_eval_step

torch.set_num_threads(2)

HEAD_STD = {"objectness": 0.1, "cls": 0.3, "bbox": 0.02}


def configs(base, **groups):
    """The same config in both packages: ``base`` is "tiny" or "default",
    ``groups`` maps a group name to field overrides."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.tiny_test_config() if base == "tiny" else mod.Config()
        for group, fields in groups.items():
            if isinstance(fields, dict):
                cfg = cfg.replace(**{group: dataclasses.replace(
                    getattr(cfg, group), **fields)})
            else:
                cfg = cfg.replace(**{group: fields})
        out.append(cfg)
    return out


def voc_shaped(**groups):
    """voc_r50's widths (ResNet-50, neck 256, RPN 512, 9 anchors, 20
    classes) on a 128-px canvas with a narrow fc."""
    data = dict(num_classes=20, canvas_height=128, canvas_width=128)
    data.update(groups.pop("data", {}))
    backbone = dict(name="resnet50")
    backbone.update(groups.pop("backbone", {}))
    roi = dict(fc_dim=64)
    roi.update(groups.pop("roi", {}))
    return configs("default", data=data, backbone=backbone, roi=roi, **groups)


def random_variables(jmodel, seed):
    """Flax init, then random FrozenBN constants and wide head kernels."""
    rng = np.random.default_rng(seed)
    v = flax.core.unfreeze(
        jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.key(seed))))
    for group, layer in (("rpn_head", "objectness"), ("det_head", "cls"),
                         ("det_head", "bbox")):
        p = v["params"][group][layer]
        p["kernel"] = rng.normal(0, HEAD_STD[layer],
                                 p["kernel"].shape).astype(np.float32)
    if "constants" in v:
        flat = flax.traverse_util.flatten_dict(v["constants"])
        for key, leaf in flat.items():
            draw = {"scale": lambda n: rng.uniform(0.5, 1.5, n),
                    "bias": lambda n: rng.normal(0, 0.1, n),
                    "mean": lambda n: rng.normal(0, 0.1, n),
                    "var": lambda n: rng.uniform(0.5, 1.5, n)}[key[-1]]
            flat[key] = draw(leaf.shape).astype(np.float32)
        v["constants"] = flax.traverse_util.unflatten_dict(flat)
    return v


def pair(jcfg, tcfg, seed=0):
    jm = JaxFasterRCNN(jcfg)
    v = random_variables(jm, seed)
    tm = build_model(tcfg, device="cpu")
    tm.core.load_state_dict(from_flax_variables(v))  # strict: every name maps
    return jm, v, tm


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(port, ref, tol=1e-4):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


# ------------------------------------------------------------ stage by stage
@pytest.mark.parametrize("stride_in_1x1", [True, False])
def test_resnet50_backbone_neck_rpn_and_head_equal_jax(stride_in_1x1):
    jcfg, tcfg = voc_shaped(
        data=dict(canvas_height=64, canvas_width=64),
        backbone=dict(stride_in_1x1=stride_in_1x1))
    jm, v, tm = pair(jcfg, tcfg)
    images = np.random.default_rng(1).normal(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jfeats = jm.core.apply(v, images, method=lambda m, x: m.backbone(x))
    with torch.no_grad():
        tfeats = tm.core.backbone(t(images).permute(0, 3, 1, 2))
    for level in ("c2", "c3", "c4", "c5"):
        close(tfeats[level].permute(0, 2, 3, 1), jfeats[level])
    jneck = jm.core.apply(v, images, method=JaxCore.features)
    with torch.no_grad():
        tneck = tm.core.features(t(images))
    close(tneck["c4"].permute(0, 2, 3, 1), jneck["c4"])
    jlogits, jdeltas = jm.core.apply(v, jneck, method=JaxCore.rpn)
    with torch.no_grad():
        tlogits, tdeltas = tm.core.rpn(tneck)
    assert tlogits.shape == (2, 4 * 4 * 9) and tdeltas.shape == (2, 144, 4)
    close(tlogits, jlogits)
    close(tdeltas, jdeltas)
    pooled = np.random.default_rng(2).normal(0, 1, (5, 7, 7, 256)).astype(
        np.float32)
    jcls, jbox = jm.core.apply(v, pooled, method=JaxCore.roi_head)
    with torch.no_grad():
        tcls, tbox = tm.core.roi_head(t(pooled))
    assert tbox.shape == (5, 20, 4)
    close(tcls, jcls)
    close(tbox, jbox)


@pytest.mark.parametrize("norm", ["gn", "frozen_bn"])
def test_tiny_backbone_features_equal_jax(norm):
    # Stride-2 3x3 SAME convs pad (0, 1) on even input, as Flax does; GN
    # uses Flax's epsilon 1e-6.
    jcfg, tcfg = configs("tiny", backbone=dict(norm=norm))
    jm, v, tm = pair(jcfg, tcfg)
    images = np.random.default_rng(3).normal(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    jfeats = jm.core.apply(v, images, method=lambda m, x: m.backbone(x))
    with torch.no_grad():
        tfeats = tm.core.backbone(t(images).permute(0, 3, 1, 2))
    for level in ("c2", "c3", "c4", "c5"):
        close(tfeats[level].permute(0, 2, 3, 1), jfeats[level])


@pytest.mark.parametrize("pre_nms_topk", [256, 64])
def test_proposals_equal_jax_given_same_rpn_outputs(pre_nms_topk):
    # 384 anchors: 256 decodes every anchor then gathers, 64 gathers first
    # (n > 4 * k_pre); both branches of the JAX function.
    jcfg, tcfg = configs("tiny", rpn=dict(pre_nms_topk_test=pre_nms_topk,
                                          min_box_size=2.0))
    jm = JaxFasterRCNN(jcfg)
    tm = build_model(tcfg, device="cpu")
    rng = np.random.default_rng(4)
    n = 8 * 8 * 6
    logits = rng.normal(0, 2, (2, n)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (2, n, 4)).astype(np.float32)
    image_hw = np.array([[128, 128], [96, 120]], np.float32)
    jb, js, jv = jm.proposals(jnp.asarray(logits), jnp.asarray(deltas),
                              jnp.asarray(image_hw), training=False,
                              canvas_hw=(128, 128))
    tb, ts, tv = tm.proposals(t(logits), t(deltas), t(image_hw),
                              canvas_hw=(128, 128))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.asarray(jv).sum() > 20
    close(tb, jb)  # invalid slots too: both carry boxes[0]
    close(ts, js, 1e-6)


@pytest.mark.parametrize("cap,agnostic", [(0, False), (40, False),
                                          (-1, False), (0, True)])
def test_postprocess_equals_jax_given_same_head_outputs(cap, agnostic):
    jcfg, tcfg = configs("tiny", roi=dict(max_nms_candidates=cap,
                                          class_agnostic_bbox=agnostic))
    jm = JaxFasterRCNN(jcfg)
    tm = build_model(tcfg, device="cpu")
    rng = np.random.default_rng(5)
    b, p, c = 2, 64, 3
    xy = rng.uniform(0, 100, (b, p, 2))
    props = np.concatenate([xy, xy + rng.uniform(4, 60, (b, p, 2))],
                           -1).astype(np.float32)
    prop_valid = rng.uniform(size=(b, p)) > 0.2
    cls_logits = rng.normal(0, 2, (b, p, c + 1)).astype(np.float32)
    deltas = rng.normal(0, 1, (b, p, 1 if agnostic else c, 4)).astype(
        np.float32)
    image_hw = np.array([[128, 128], [100, 128]], np.float32)
    ref = jax.vmap(jm._postprocess_single)(
        jnp.asarray(props), jnp.asarray(prop_valid), jnp.asarray(cls_logits),
        jnp.asarray(deltas), jnp.asarray(image_hw))
    out = tm._postprocess_single(t(props), t(prop_valid), t(cls_logits),
                                 t(deltas), t(image_hw))
    jboxes, jscores, jclasses, jvalid = (np.asarray(x) for x in ref)
    tboxes, tscores, tclasses, tvalid = (x.numpy() for x in out)
    np.testing.assert_array_equal(tvalid, jvalid)
    np.testing.assert_array_equal(tclasses, jclasses)
    assert jvalid.sum() > 10
    close(tboxes, jboxes)
    close(tscores, jscores, 1e-6)


# ------------------------------------------------------------ whole slice
def assert_same_detections(port, ref):
    """Same valid masks, classes, boxes and scores. The two frameworks feed
    the final NMS scores that differ by float error (~1e-5 here), so two
    detections whose scores tie within that error may trade places; every
    other slot must match in place."""
    np.testing.assert_array_equal(port["valid"], ref["valid"])
    np.testing.assert_array_equal(port["num_detections"],
                                  ref["num_detections"])
    for b in range(ref["valid"].shape[0]):
        n = int(ref["num_detections"][b])
        free = list(range(n))
        for i in range(n):
            match = [k for k in free
                     if port["classes"][b, k] == ref["classes"][b, i]
                     and abs(port["scores"][b, k] - ref["scores"][b, i]) < 1e-4
                     and np.allclose(port["boxes"][b, k], ref["boxes"][b, i],
                                     rtol=1e-4, atol=1e-3)]
            assert match, f"detection {i} of image {b} has no counterpart"
            k = min(match, key=lambda m: abs(m - i))
            assert k == i or abs(ref["scores"][b, k] - ref["scores"][b, i]) < 1e-4
            free.remove(k)
        assert (port["scores"][b, n:] == 0).all()
        assert (port["classes"][b, n:] == 0).all()


@pytest.mark.parametrize("shape", ["tiny", "voc_r50"])
def test_predict_equals_jax(shape):
    """make_eval_step (uint8 canvases, fused preprocess) against the JAX
    eval program, weights carried over by from_flax_variables. Boxes: atol
    1e-3 px plus rtol 1e-4 (coordinates up to 128 px carry the backbone's
    ~1e-5 relative error through the box decode)."""
    jcfg, tcfg = configs("tiny") if shape == "tiny" else voc_shaped()
    jm, v, tm = pair(jcfg, tcfg, seed=6)
    rng = np.random.default_rng(7)
    batch = {"image": rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8),
             "image_hw": np.array([[128, 128], [96, 128]], np.float32)}
    ref = jax.jit(lambda v, bt: jm.predict(v, jax_preprocess(jcfg, bt)))(
        v, batch)
    ref = {k: np.asarray(x) for k, x in ref.items()}
    out = {k: x.numpy() for k, x in make_eval_step(tm, tcfg)(batch).items()}
    assert set(out) == set(ref)
    assert (ref["num_detections"] > 5).all()
    assert_same_detections(out, ref)


def test_rpn_only_predict_equals_jax():
    jcfg, tcfg = configs("tiny", rpn_only=True)
    jm, v, tm = pair(jcfg, tcfg, seed=8)
    rng = np.random.default_rng(9)
    batch = {"image": rng.normal(0, 1, (2, 128, 128, 3)).astype(np.float32),
             "image_hw": np.array([[128, 128], [128, 80]], np.float32)}
    ref = {k: np.asarray(x) for k, x in jm.predict(v, batch).items()}
    out = {k: x.numpy() for k, x in tm.predict(
        {k: t(x) for k, x in batch.items()}).items()}
    np.testing.assert_array_equal(out["valid"], ref["valid"])
    np.testing.assert_array_equal(out["classes"], ref["classes"])
    close(out["boxes"], ref["boxes"], 1e-3)
    close(out["scores"], ref["scores"], 1e-4)


# ------------------------------------------------------------ weights
def test_init_draws_flax_distributions():
    _, tcfg = voc_shaped()
    model = build_model(tcfg, device="cpu").init(seed=3)
    core = model.core
    w = core.backbone.stage4_block0.conv2.weight  # fan_in 3 * 3 * 256
    std = (1.0 / (9 * 256)) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.05
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(core.det_head.cls.weight.std().item() / 0.01 - 1) < 0.1
    assert abs(core.det_head.bbox.weight.std().item() / 0.001 - 1) < 0.1
    assert abs(core.rpn_head.objectness.weight.std().item() / 0.01 - 1) < 0.2
    assert (core.rpn_head.conv.bias == 0).all()
    bn = core.backbone.norm_stem
    assert (bn.scale == 1).all() and (bn.var == 1).all() and (bn.mean == 0).all()
    again = build_model(tcfg, device="cpu").init(seed=3)
    assert torch.equal(again.core.det_head.fc1.weight, core.det_head.fc1.weight)
