"""Cascade R-CNN of the PyTorch port against ``tpudet``'s, on the CPU: the
constructor's refusals, stage relabeling (``_cascade_targets_single``) on
tpudet's hand scene and on random boxes, the detached box chain
(``_refine_boxes``), ``loss`` given JAX's sampler draws, the boxes each
stage pools in ``predict`` and the final detections, on ``cascade_tiny``
(single-level c4) and on its FPN variant with the windowed pooler at window
56.

Weights: Flax's init with ``test_torch_faster_rcnn.random_variables``'s
widened heads, and the later stages' ``cls`` kernels widened the same way
and their ``bbox`` kernels ten times wider still (their deltas are divided
by the stages' weights of 20 and 30: at Flax's normal(0.001) the chain
would leave the boxes where they were and hide a fault in it).

Tolerances (f32): relabeling's classes, foreground and validity exactly
equal, deltas within ``1e-5``; refined boxes within ``1e-4`` px; every
loss term within ``1e-5`` relative; each gradient within ``1e-4`` of its
largest magnitude plus ``1e-5`` of its own values, plus ``1e-6`` of the
model's largest gradient (as ``tests/test_torch_fpn_train.py``); each
stage's pooled boxes within ``1e-3`` px plus ``1e-4`` relative (the
voc_r50 predict tolerance of ``tests/test_torch_faster_rcnn.py``), and the
detections as ``assert_same_detections``.

The training batch is ``train_batch``'s seed 10. At its seed 9 one unit of
the FPN variant's tiny backbone (after the last GroupNorm) sits within
f32 rounding of the ReLU's kink, the two packages round it to its two
sides, and the backbone's gradients part by a few percent of their
largest magnitude (each package is right to f32; the FPN and head
gradients still agree).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_deformable_detr_train import train_batch
from tests.test_torch_faster_rcnn import (
    HEAD_STD,
    assert_same_detections,
    random_variables,
)
from tests.test_torch_faster_rcnn_train import jax_draws, t
from tpudet import config as jconfig
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.models import CascadeRCNN as JaxCascadeRCNN
from tpudet.models.faster_rcnn import DetectorCore as JaxCore
from tpudet_torch import config as tconfig
from tpudet_torch.data.preprocess import device_preprocess
from tpudet_torch.models import build_model
from tpudet_torch.models.cascade_rcnn import CascadeRCNN
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.train.step import make_eval_step

torch.set_num_threads(2)
STAGES = (1, 2, 3)
METRICS = {"loss", "rpn_cls_loss", "rpn_box_loss", "num_pos_anchors"} | {
    f"{name}_s{s}" for s in STAGES
    for name in ("det_cls_loss", "det_box_loss", "num_fg_rois")}


def cascade_configs(variant):
    """cascade_tiny in both packages; "fpn": with the FPN and the windowed
    pooler at window 56."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.tiny_cascade_config()
        if variant == "fpn":
            cfg = cfg.replace(
                backbone=dataclasses.replace(cfg.backbone, use_fpn=True),
                roi=dataclasses.replace(cfg.roi, pooler="roi_align_window",
                                        window=56))
        out.append(cfg)
    return out


def cascade_pair(jcfg, tcfg, seed):
    jm = JaxCascadeRCNN(jcfg)
    v = random_variables(jm, seed)
    rng = np.random.default_rng(seed + 1)
    for head in ("det_head2", "det_head3"):
        for layer, scale in (("cls", 1.0), ("bbox", 10.0)):
            p = v["params"][head][layer]
            p["kernel"] = rng.normal(0, scale * HEAD_STD[layer],
                                     p["kernel"].shape).astype(np.float32)
    tm = build_model(tcfg, device="cpu")
    assert isinstance(tm, CascadeRCNN)
    tm.core.load_state_dict(from_flax_variables(v))  # strict
    return jm, v, tm


# ------------------------------------------------------------ constructor
@pytest.mark.parametrize("case,match", [
    ("agnostic", "class_agnostic"), ("one_stage", ">= 2 stages"),
    ("lists", "disagree"), ("order", "non-decreasing")])
def test_constructor_refusals_as_jax(case, match):
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = mod.tiny_cascade_config()
        c = cfg.cascade
        cfg = {
            "agnostic": lambda: cfg.replace(roi=dataclasses.replace(
                cfg.roi, class_agnostic_bbox=False)),
            "one_stage": lambda: cfg.replace(cascade=dataclasses.replace(
                c, stage_iou_thresholds=(0.5,),
                stage_box_reg_weights=((10.0, 10.0, 5.0, 5.0),),
                stage_loss_weights=(1.0,))),
            "lists": lambda: cfg.replace(cascade=dataclasses.replace(
                c, stage_loss_weights=(1.0, 1.0))),
            "order": lambda: cfg.replace(cascade=dataclasses.replace(
                c, stage_iou_thresholds=(0.7, 0.6, 0.5))),
        }[case]()
        cfgs.append(cfg)
    with pytest.raises(ValueError, match=match) as ref:
        JaxCascadeRCNN(cfgs[0])
    with pytest.raises(ValueError, match=match) as port:
        build_model(cfgs[1], device="cpu")
    assert str(port.value) == str(ref.value)


# ------------------------------------------------------------ relabeling
def relabel_both(thresh, weights, boxes, valid, gt, gt_cls, gt_valid):
    """tpudet's ``_cascade_targets_single`` per image (vmapped) and the
    port's on the batch."""
    jcfg, tcfg = jconfig.tiny_cascade_config(), tconfig.tiny_cascade_config()
    jm, tm = JaxCascadeRCNN(jcfg), build_model(tcfg, device="cpu")
    ref = jax.vmap(lambda *a: jm._cascade_targets_single(
        thresh, jnp.asarray(weights), *a))(boxes, valid, gt, gt_cls, gt_valid)
    port = tm._cascade_targets_single(thresh, weights, t(boxes), t(valid),
                                      t(gt), t(gt_cls), t(gt_valid))
    return [np.asarray(x) for x in ref], [x.numpy() for x in port]


def assert_same_targets(ref, port):
    cls, deltas, fg, valid = ref
    np.testing.assert_array_equal(port[0], cls)
    np.testing.assert_array_equal(port[2], fg)
    np.testing.assert_array_equal(port[3], valid)
    np.testing.assert_allclose(port[1][fg], deltas[fg], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("thresh", [0.5, 0.6, 0.7])
def test_cascade_targets_hand_scene(thresh):
    """tpudet's hand scene (tests/test_cascade.py): IoU 1, 0.55, 0.65 and an
    invalid row, at each stage's threshold."""
    g = 10
    gt = np.zeros((1, g, 4), np.float32)
    gt[0, 0] = [0, 0, 100, 100]
    gt_cls = np.zeros((1, g), np.int32)
    gt_cls[0, 0] = 2
    gt_valid = np.zeros((1, g), bool)
    gt_valid[0, 0] = True
    boxes = np.array([[[0, 0, 100, 100], [0, 0, 55, 100], [0, 0, 65, 100],
                       [50, 50, 60, 60]]], np.float32)
    valid = np.array([[True, True, True, False]])
    w = tconfig.CascadeConfig().stage_box_reg_weights[1]
    ref, port = relabel_both(thresh, w, boxes, valid, gt, gt_cls, gt_valid)
    assert_same_targets(ref, port)
    want = {0.5: [1, 1, 1], 0.6: [1, 0, 1], 0.7: [1, 0, 0]}[thresh]
    np.testing.assert_array_equal(port[2][0, :3], np.asarray(want, bool))
    assert port[3][0, :3].all() and not port[3][0, 3]
    np.testing.assert_allclose(port[1][0, 0], 0.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cascade_targets_random(seed):
    rng = np.random.default_rng(seed)
    b, k, g = 2, 64, 10
    centre = rng.uniform(20, 100, (b, g, 2))
    size = rng.uniform(10, 60, (b, g, 2))
    gt = np.concatenate([centre - size / 2, centre + size / 2], -1)
    # RoIs jittered about the ground truth so every threshold sees both
    # sides.
    pick = rng.integers(0, g, (b, k))
    base = np.take_along_axis(gt, pick[..., None], 1)
    jitter = rng.normal(0, 0.15, (b, k, 4)) * np.tile(
        np.take_along_axis(size, pick[..., None], 1), 2)
    boxes = (base + jitter).astype(np.float32)
    gt = gt.astype(np.float32)
    gt_cls = rng.integers(1, 4, (b, g)).astype(np.int32)
    gt_valid = rng.uniform(size=(b, g)) < 0.7
    valid = rng.uniform(size=(b, k)) < 0.9
    for thresh, w in zip((0.6, 0.7), tconfig.CascadeConfig()
                         .stage_box_reg_weights[1:]):
        ref, port = relabel_both(thresh, w, boxes, valid, gt, gt_cls,
                                 gt_valid)
        assert_same_targets(ref, port)
        assert 5 < ref[2].sum() < ref[3].sum()


def test_refine_boxes_equal_jax_and_detached():
    jcfg, tcfg = jconfig.tiny_cascade_config(), tconfig.tiny_cascade_config()
    jm, tm = JaxCascadeRCNN(jcfg), build_model(tcfg, device="cpu")
    rng = np.random.default_rng(3)
    boxes = np.sort(rng.uniform(0, 128, (2, 16, 2, 2)), axis=2).transpose(
        0, 1, 3, 2).reshape(2, 16, 4).astype(np.float32)
    deltas = rng.normal(0, 2.0, (2, 16, 1, 4)).astype(np.float32)
    deltas[0, 0, 0, 2:] = 8.0  # past the decode's clamp of dw, dh
    hw = np.array([[128, 128], [96, 112]], np.float32)
    for w in tcfg.cascade.stage_box_reg_weights:
        ref = np.asarray(jm._refine_boxes(jnp.asarray(boxes),
                                          jnp.asarray(deltas),
                                          jnp.asarray(hw), w))
        d = t(deltas).requires_grad_()
        port = tm._refine_boxes(t(boxes), d, t(hw), w)
        np.testing.assert_allclose(port.detach().numpy(), ref, atol=1e-4,
                                   rtol=1e-5)
        assert not port.requires_grad  # the chain is detached
    assert (ref[1, :, 2] <= 112).all() and (ref[1, :, 3] <= 96).all()
    # JAX's: no gradient through the chain either.
    grad = jax.grad(lambda d: jnp.sum(jm._refine_boxes(
        jnp.asarray(boxes), d, jnp.asarray(hw), w)))(jnp.asarray(deltas))
    assert not np.asarray(grad).any()


# ------------------------------------------------------------ the model
def jax_stage_boxes(jm, v, images, image_hw):
    """The boxes each stage of tpudet's predict pools, and the last
    refinement (the output boxes before the NMS)."""
    feats = jm.core.apply(v, images, method=JaxCore.features)
    logits, deltas = jm.core.apply(v, feats, method=JaxCore.rpn)
    boxes, _, valid = jm.proposals(logits, deltas, image_hw, training=False,
                                   canvas_hw=images.shape[1:3])
    seen = []
    for st, w in enumerate(jm.cfg.cascade.stage_box_reg_weights):
        seen.append(boxes)
        _, d = jm._stage_head(v, feats, boxes, stage=st, training=False)
        boxes = jm._refine_boxes(boxes, d, image_hw, w)
    return seen + [boxes], valid


@pytest.fixture(scope="module", params=["c4", "fpn"])
def run(request):
    """One loss and gradient, the stages' boxes and one predict of each
    package."""
    jcfg, tcfg = cascade_configs(request.param)
    jm, v, tm = cascade_pair(jcfg, tcfg, seed=21)
    batch = train_batch(tcfg, seed=10)
    rng = jax.random.key(13)

    def loss(params):
        return jm.loss({**v, "params": params}, batch, rng)

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    shapes = tm.draw_shapes(2, batch["image"].shape[1:3])
    draws = jax_draws(rng, 2, shapes["rpn"][1], shapes["roi"][1])
    total, port_metrics = tm.loss({k: t(x) for k, x in batch.items()},
                                  draws=draws)
    total.backward()

    prng = np.random.default_rng(10)
    pbatch = {"image": prng.integers(0, 256, (2, 128, 128, 3),
                                     dtype=np.uint8),
              "image_hw": np.array([[128, 128], [96, 120]], np.float32)}
    ref = jax.jit(lambda v, bt: jm.predict(v, jax_preprocess(jcfg, bt)))(
        v, pbatch)
    out = make_eval_step(tm, tcfg)(pbatch)
    def stages(v, bt):
        bt = jax_preprocess(jcfg, bt)
        return jax_stage_boxes(jm, v, bt["image"], bt["image_hw"])

    jseen, jvalid = jax.jit(stages)(v, pbatch)
    pre = device_preprocess(tcfg, {k: t(x) for k, x in pbatch.items()})
    seen = []
    original = tm._stage_head

    def recording(feats, boxes, stage):
        seen.append(boxes)
        return original(feats, boxes, stage)

    tm._stage_head = recording
    with torch.inference_mode():
        final = tm.predict(pre)
    del tm._stage_head
    return dict(
        variant=request.param, tm=tm, tcfg=tcfg,
        metrics=({k: float(x) for k, x in metrics.items()},
                 {k: float(x.detach()) for k, x in port_metrics.items()}),
        grads=from_flax_variables({"params": grads}),
        predict=({k: np.asarray(x) for k, x in ref.items()},
                 {k: x.numpy() for k, x in out.items()}),
        final=final,
        stages=([np.asarray(x) for x in jseen], np.asarray(jvalid),
                [x.numpy() for x in seen]))


def test_loss_terms_equal_jax(run):
    ref, port = run["metrics"]
    assert set(port) == set(ref) == METRICS
    for k in ref:
        assert port[k] == pytest.approx(ref[k], rel=1e-5), k
    for s in STAGES:
        assert ref[f"num_fg_rois_s{s}"] > 0 and ref[f"det_box_loss_s{s}"] > 0


def test_gradients_equal_jax(run):
    tm, ref_grads = run["tm"], run["grads"]
    assert set(n for n, _ in tm.core.named_parameters()) == set(ref_grads)
    floor = 1e-6 * max(float(g.abs().max()) for g in ref_grads.values())
    for name, p in tm.core.named_parameters():
        want = ref_grads[name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-4 * np.abs(want).max() + floor,
                                   err_msg=name)
    # Every stage's head trains.
    for head in ("det_head", "det_head2", "det_head3"):
        assert getattr(tm.core, head).bbox.weight.grad.abs().max() > 0


def test_stage_boxes_equal_jax(run):
    """Each stage pools the boxes tpudet's does (proposals, then each
    refinement), and the last refinement is the output's boxes."""
    ref, valid, port = run["stages"]
    assert len(port) == 3 and len(ref) == 4
    for st in range(3):
        np.testing.assert_allclose(port[st][valid], ref[st][valid],
                                   rtol=1e-4, atol=1e-3, err_msg=f"stage {st}")
    moved = np.abs(ref[2] - ref[0])[valid].max()
    assert moved > 1.0  # the chain moves the boxes
    kept = run["final"]["boxes"][run["final"]["valid"]].numpy()
    last = ref[3][valid]
    # Every output box is one of the last refinement's.
    assert all(np.abs(last - box).max(axis=1).min() < 1e-3 for box in kept)


def test_predict_equals_jax(run):
    ref, out = run["predict"]
    assert set(out) == set(ref)
    assert (ref["num_detections"] > 3).all()
    assert_same_detections(out, ref)


def test_rpn_only_falls_back_to_faster_rcnn():
    jcfg, tcfg = cascade_configs("c4")
    jm, v, tm = cascade_pair(jcfg.replace(rpn_only=True),
                             tcfg.replace(rpn_only=True), seed=5)
    batch = train_batch(tcfg, seed=2)
    rng = jax.random.key(1)
    _, ref = jax.jit(jm.loss)(v, batch, rng)
    shapes = tm.draw_shapes(2, batch["image"].shape[1:3])
    draws = jax_draws(rng, 2, shapes["rpn"][1], shapes["roi"][1])
    _, port = tm.loss({k: t(x) for k, x in batch.items()}, draws=draws)
    assert set(port) == set(ref) == {"loss", "rpn_cls_loss", "rpn_box_loss",
                                     "num_pos_anchors"}
    for k in ref:
        assert float(port[k]) == pytest.approx(float(ref[k]), rel=1e-5), k
