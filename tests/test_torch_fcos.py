"""FCOS of the PyTorch port against ``tpudet``'s, on the CPU, at
``fcos_tiny``: the point grid (points, strides, regression ranges, level
sizes) and ``generate_points_np``, the constructor's refusals, the
pyramid and the GroupNorm head on every level with the level scales, the
dense targets (matched classes, boxes, centerness, positives; the smallest
box wins a tie, the first of equal ones), ``fcos_losses`` with and without
positives, ``loss`` and its gradients (``level_scales`` included),
``predict``, the tiny learning check at tpudet's bar (``tests/test_fcos.py``:
SGD 0.02, no warmup, 15 steps, the last loss under 0.8x the first) and the
CLIs.

Weights: Flax's init with the output convs drawn wider and the level
scales moved off 1 (``test_torch_retinanet.widened``; FCOS's scores are
``sigmoid(class) * sigmoid(centerness)``, about 0.005 at Flax's init).

Tolerances (f32): as ``tests/test_torch_retinanet.py``: the grid, target
classes and positives exactly equal, target boxes and centerness within
1e-6, the pyramid and head per level within 1e-5 relative, loss terms
within 1e-5 relative, gradients within 1e-4 of their largest magnitude
(plus 1e-5 of their values and 1e-6 of the model's largest gradient),
detections as ``assert_same_detections`` there.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_deformable_detr_train import train_batch
from tests.test_torch_retinanet import (
    LEVELS,
    assert_grads_equal,
    assert_levels_close,
    assert_same_detections,
    cli_train_eval_detect,
    learning_losses,
    predict_both,
    t,
    uint8_batch,
    widened,
)
from tpudet import config as jconfig
from tpudet.models import FCOS as JaxFCOS
from tpudet.models.fcos import FCOSCore as JaxCore
from tpudet.ops import anchors as jax_anchors
from tpudet.train import losses as jax_losses
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models.fcos import FCOS
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.ops import anchors as tanchors
from tpudet_torch.train import losses as tlosses

torch.set_num_threads(2)
METRICS = {"loss", "focal_cls_loss", "giou_box_loss", "centerness_loss",
           "num_pos_points"}


def configs(**fields):
    return [c.replace(fcos=dataclasses.replace(c.fcos, **fields))
            for c in (jconfig.tiny_fcos_config(), tconfig.tiny_fcos_config())]


def pair(jm, tcfg, seed):
    v = widened(jax.jit(jm.init)(jax.random.key(seed)), seed)
    rng = np.random.default_rng(seed + 1)
    v["params"]["level_scales"] = rng.uniform(
        0.5, 1.5, v["params"]["level_scales"].shape).astype(np.float32)
    tm = build_model(tcfg, device="cpu")
    tm.core.load_state_dict(from_flax_variables(v))  # strict
    return v, tm


# ---------------------------------------------------------------- geometry
@pytest.mark.parametrize("canvas", [(128, 128), (96, 160), (832, 1344)])
def test_point_grid_equals_jax(canvas):
    from tpudet.cli.common import preset_config as jax_preset
    from tpudet_torch.cli.common import preset_config

    for name in ("fcos_tiny", "coco_fcos_r50"):
        jm = JaxFCOS(jax_preset(name))
        tm = build_model(preset_config(name), device="cpu")
        ref, out = jm.point_grid(canvas), tm.point_grid(canvas)
        for a, b in zip(out[:4], ref[:4]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert out[4] == ref[4]
    np.testing.assert_array_equal(tanchors.generate_points_np(7, 9, 16),
                                  jax_anchors.generate_points_np(7, 9, 16))


@pytest.mark.parametrize("case,match", [
    ("det_only", "det_only"), ("no_fpn", "use_fpn"),
    ("strides", "fixed P3-P7"), ("bounds", "regress_range_bounds")])
def test_constructor_refusals_as_jax(case, match):
    cfgs = []
    for cfg in (jconfig.tiny_fcos_config(), tconfig.tiny_fcos_config()):
        cfgs.append({
            "det_only": lambda: cfg.replace(det_only=True),
            "no_fpn": lambda: cfg.replace(backbone=dataclasses.replace(
                cfg.backbone, use_fpn=False)),
            "strides": lambda: cfg.replace(anchors=dataclasses.replace(
                cfg.anchors, fpn_strides=(4, 8, 16, 32, 64))),
            "bounds": lambda: cfg.replace(fcos=dataclasses.replace(
                cfg.fcos, regress_range_bounds=(16.0, 32.0))),
        }[case]())
    with pytest.raises(ValueError, match=match) as ref:
        JaxFCOS(cfgs[0])
    with pytest.raises(ValueError, match=match) as port:
        build_model(cfgs[1], device="cpu")
    assert str(port.value) == str(ref.value)
    assert isinstance(build_model(tconfig.tiny_fcos_config(), device="cpu"),
                      FCOS)


# --------------------------------------------------------------- targets
def jax_targets(jm, canvas, gt, gt_cls, gt_valid):
    pts, st, lo, hi, _ = jm.point_grid(canvas)
    return [np.asarray(x) for x in jax.jit(jax.vmap(functools.partial(
        jm._targets_single, pts, st, lo, hi)))(gt, gt_cls, gt_valid)]


def assert_same_targets(tm, canvas, ref, gt, gt_cls, gt_valid):
    pts, st, lo, hi, _ = tm.point_grid(canvas)
    out = [x.numpy() for x in tm._targets_single(
        pts, st, lo, hi, t(gt), t(gt_cls), t(gt_valid))]
    cls, boxes, ctr, pos = ref
    np.testing.assert_array_equal(out[3], pos)
    np.testing.assert_array_equal(out[0], cls)
    np.testing.assert_allclose(out[2], ctr, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[1][pos], boxes[pos], rtol=0, atol=1e-6)
    return out


@pytest.mark.parametrize("radius", [1.5, 0.0])
def test_targets_equal_jax_random(radius):
    """Random boxes (some nested, some invalid) under centre sampling and
    the paper's anywhere-inside rule."""
    jcfg, tcfg = configs(center_sampling_radius=radius)
    jm, tm = JaxFCOS(jcfg), build_model(tcfg, device="cpu")
    rng = np.random.default_rng(7)
    b, g = 2, 10
    centre = rng.uniform(10, 118, (b, g, 2))
    size = rng.uniform(6, 100, (b, g, 2))
    gt = np.concatenate([centre - size / 2, centre + size / 2], -1).astype(
        np.float32)
    gt[:, 1] = gt[:, 0] + np.array([4, 4, -4, -4], np.float32)  # nested
    gt_cls = rng.integers(1, 4, (b, g)).astype(np.int32)
    gt_valid = rng.uniform(size=(b, g)) < 0.8
    ref = jax_targets(jm, (128, 128), gt, gt_cls, gt_valid)
    assert_same_targets(tm, (128, 128), ref, gt, gt_cls, gt_valid)
    assert 10 < ref[3].sum() < ref[3].size


def test_tie_goes_to_the_smallest_then_first_box():
    """Three boxes around one point: the smallest wins; of two equal ones
    the first."""
    jcfg, tcfg = configs(center_sampling_radius=0.0)
    jm, tm = JaxFCOS(jcfg), build_model(tcfg, device="cpu")
    g = 10
    gt = np.zeros((1, g, 4), np.float32)
    gt[0, :3] = [[40, 40, 72, 72], [44, 44, 68, 68], [44, 44, 68, 68]]
    gt_cls = np.zeros((1, g), np.int32)
    gt_cls[0, :3] = [1, 2, 3]
    gt_valid = np.zeros((1, g), bool)
    gt_valid[0, :3] = True
    ref = jax_targets(jm, (128, 128), gt, gt_cls, gt_valid)
    out = assert_same_targets(tm, (128, 128), ref, gt, gt_cls, gt_valid)
    # The p3 point at (60, 60): inside all three, the 24-px box's.
    pts = tm.point_grid((128, 128))[0].numpy()
    i = int(np.flatnonzero((pts[:, 0] == 60) & (pts[:, 1] == 60))[0])
    assert out[3][0, i] and out[0][0, i] == 2


def test_fcos_losses_equal_jax_with_and_without_positives():
    rng = np.random.default_rng(3)
    n, c = 50, 3
    logits = rng.normal(0, 2, (2, n, c)).astype(np.float32)
    xy = rng.uniform(0, 60, (2, n, 2))
    pred = np.concatenate([xy, xy + rng.uniform(2, 40, (2, n, 2))],
                          -1).astype(np.float32)
    tgt = (pred + rng.normal(0, 4, pred.shape)).astype(np.float32)
    ctr_logits = rng.normal(0, 1, (2, n)).astype(np.float32)
    ctr = rng.uniform(0, 1, (2, n)).astype(np.float32)
    pos = rng.uniform(size=(2, n)) < 0.3
    pos[1] = False  # no positive: box 0, normalizers clamped
    cls = np.where(pos, rng.integers(1, c + 1, (2, n)), 0).astype(np.int32)
    ref = jax.vmap(jax_losses.fcos_losses)(logits, pred, ctr_logits, cls, tgt,
                                           ctr, pos)
    out = tlosses.fcos_losses(t(logits), t(pred), t(ctr_logits), t(cls),
                              t(tgt), t(ctr), t(pos))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    assert float(out[1][1]) == 0.0 and float(out[2][1]) == 0.0


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def run():
    jcfg, tcfg = configs()
    jm = JaxFCOS(jcfg)
    v, tm = pair(jm, tcfg, seed=3)
    batch = train_batch(tcfg, seed=5)
    images = jnp.asarray(batch["image"])

    def forward(v, images):
        feats = jm.core.apply(v, images, method=JaxCore.features)
        return feats, jm.core.apply(v, feats, method=JaxCore.heads)

    feats, heads = jax.jit(forward)(v, images)

    def loss(params):
        return jm.loss({**v, "params": params}, batch, jax.random.key(0))

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    return dict(
        jm=jm, v=v, tm=tm, jcfg=jcfg, tcfg=tcfg, batch=batch,
        targets=jax_targets(jm, (128, 128), batch["gt_boxes"],
                            batch["gt_classes"], batch["gt_valid"]),
        feats={k: np.asarray(x) for k, x in feats.items()},
        heads=[np.asarray(x) for x in heads],
        metrics={k: float(x) for k, x in metrics.items()},
        grads=from_flax_variables({"params": grads}))


def test_pyramid_equals_jax_per_level(run):
    tm = run["tm"]
    with torch.no_grad():
        feats = tm.core.features(t(run["batch"]["image"]))
    for name in LEVELS:
        assert_levels_close(feats[name].permute(0, 2, 3, 1).numpy(),
                            run["feats"][name], name)


def test_head_equals_jax_per_level(run):
    """The head and the level scales on one pyramid of random features at
    a 256-px canvas's level sizes, level by level. (At 128 px p7 is one
    cell, and each GroupNorm group normalizes two values: their difference
    carries the convolution's rounding, and the two packages' outputs part
    by 2e-5 of the level's largest there.)"""
    jm, v, tm = run["jm"], run["v"], run["tm"]
    rng = np.random.default_rng(11)
    feats = {name: rng.normal(0, 1, (2, 256 // s, 256 // s, 256)).astype(
        np.float32) for name, s in zip(LEVELS, (8, 16, 32, 64, 128))}
    ref = jax.jit(lambda v, f: jm.core.apply(v, f, method=JaxCore.heads))(
        v, feats)
    with torch.no_grad():
        heads = tm.core.heads({k: t(x).permute(0, 3, 1, 2)
                               for k, x in feats.items()})
    start = 0
    for name, n in zip(LEVELS, tm.point_grid((256, 256))[4]):
        for port, want, what in zip(heads, ref,
                                    ("logits", "distances", "centerness")):
            assert_levels_close(port[:, start:start + n].numpy(),
                                np.asarray(want)[:, start:start + n],
                                f"{name} {what}")
        start += n
    assert start == heads[0].shape[1]


def test_targets_equal_jax(run):
    b = run["batch"]
    assert_same_targets(run["tm"], (128, 128), run["targets"], b["gt_boxes"],
                        b["gt_classes"], b["gt_valid"])


def test_loss_terms_and_gradients_equal_jax(run):
    tm, ref = run["tm"], run["metrics"]
    total, metrics = tm.loss({k: t(x) for k, x in run["batch"].items()})
    assert set(metrics) == set(ref) == METRICS
    for k in ref:
        assert float(metrics[k].detach()) == pytest.approx(ref[k], rel=1e-5), k
    assert ref["num_pos_points"] > 3 and ref["giou_box_loss"] > 0
    total.backward()
    assert_grads_equal(tm, run["grads"])
    # p6 and p7 regress boxes over 64 px: this batch gives them none.
    assert (tm.core.level_scales.grad[:3].abs() > 0).all()


def test_predict_equals_jax():
    jcfg, tcfg = configs()
    jm = JaxFCOS(jcfg)
    v, tm = pair(jm, tcfg, seed=6)
    out, ref = predict_both(jm, v, jcfg, tm, tcfg, uint8_batch(7))
    assert (ref["num_detections"] > 5).all()
    assert_same_detections(out, ref)


def test_init_scales_and_prior():
    tm = build_model(tconfig.tiny_fcos_config(), device="cpu").init(0)
    assert torch.equal(tm.core.level_scales.detach(), torch.ones(5))
    bias = tm.core.head.cls_logits.bias.detach()
    assert torch.allclose(torch.sigmoid(bias), torch.full_like(bias, 0.01))
    assert float(tm.core.head.cls_gn0.weight.detach().min()) == 1.0


# --------------------------------------------------------------- learning
def test_tiny_learning_check():
    """tpudet's bar (tests/test_fcos.py): SGD 0.02, no warmup, 15 steps on
    one synthetic batch; the first loss under 10, the last under 0.8x the
    first."""
    cfg = tconfig.tiny_fcos_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, learning_rate=0.02, warmup_steps=0))
    losses = learning_losses(cfg, 15)
    first, last = losses[0], losses[-1]
    assert np.isfinite(losses).all() and first < 10.0
    assert last < 0.8 * first, (first, last)


def test_cli_train_eval_detect(tmp_path, capsys):
    _, boxes = cli_train_eval_detect(
        tmp_path, capsys, "fcos_tiny", "centerness_loss=",
        ["fcos.score_thresh=0.0"])
    assert len(boxes) > 0
