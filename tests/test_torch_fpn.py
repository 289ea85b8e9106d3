"""The FPN inference path of the PyTorch port (``coco_r101_fpn``) against
the JAX package on the CPU: the FPN anchors, ``blocked_top_k``, the
per-level proposals, the whole predict and the weight import (ResNet-101
and the FPN levels: ``tests/test_torch_fpn_features.py``).

Tolerances. Selections (top-k, proposals' NMS): exact indices and valid
masks; proposal boxes ``rtol/atol 1e-4``. Whole predict: the detections of
``tests/test_torch_faster_rcnn.py::assert_same_detections`` (two detections
whose scores tie within the backends' float error may trade places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_faster_rcnn import (
    assert_same_detections,
    close,
    configs,
    pair,
    t,
)
from tpudet.cli.common import preset_config as jax_preset
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.models import FasterRCNN as JaxFasterRCNN
from tpudet.ops import selection as jsel
from tpudet_torch.cli.common import preset_config
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.ops import selection
from tpudet_torch.train.step import make_eval_step

torch.set_num_threads(2)


# ------------------------------------------------------------ anchors, top-k
def test_fpn_anchors_and_level_sizes_equal_jax():
    jm = JaxFasterRCNN(jax_preset("coco_r101_fpn"))
    tm = build_model(preset_config("coco_r101_fpn"), device="cpu")
    for canvas in ((832, 1120), (832, 832)):
        ref = np.asarray(jm.anchor_boxes(canvas))
        out = tm.anchor_boxes(canvas)
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), ref)
        assert tm.anchor_level_sizes(canvas) == jm.anchor_level_sizes(canvas)
    assert sum(tm.anchor_level_sizes((832, 832))) == 172887


# (n, k, block): blocks with a padded last block; the P2 shape of the
# 832x832 bucket; falls back for k >= n, n <= block and a merge operand of
# at least n / 2.
TOPK_CASES = [(3000, 64, 512), (129792, 1000, 8192), (3000, 3000, 512),
              (3000, 64, 4096), (1000, 300, 256)]


@pytest.mark.parametrize("n,k,block", TOPK_CASES)
@pytest.mark.parametrize("ties", ["dense", "distinct"])
def test_blocked_top_k_equals_lax_top_k(n, k, block, ties):
    rng = np.random.default_rng(n + k)
    if ties == "dense":
        scores = rng.integers(0, 5, (2, n)).astype(np.float32)
    else:
        scores = rng.normal(0, 3, (2, n)).astype(np.float32)
    vals, idx = selection.blocked_top_k(t(scores), k, block)
    for b in range(2):
        for ref in (jax.lax.top_k(jnp.asarray(scores[b]), k),
                    jsel.blocked_top_k(jnp.asarray(scores[b]), k, block)):
            np.testing.assert_array_equal(vals[b].numpy(), np.asarray(ref[0]))
            np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ref[1]))


# ------------------------------------------------------------ proposals
@pytest.mark.parametrize("method", ["blocked", "exact"])
def test_fpn_proposals_equal_jax_given_same_rpn_outputs(method):
    """Per-level top-64 with 512-wide blocks on the 128-px canvas: p2
    (3072 anchors) and p3 (768) really block, p4..p6 fall back. Logits
    rounded to 0.1 tie densely."""
    rpn = dict(fpn_pre_nms_topk_per_level_test=64, topk_block_size=512,
               topk_method=method, min_box_size=2.0)
    jcfg, tcfg = configs("tiny", backbone=dict(use_fpn=True), rpn=rpn)
    jm = JaxFasterRCNN(jcfg)
    tm = build_model(tcfg, device="cpu")
    n = sum(tm.anchor_level_sizes((128, 128)))
    assert n == 4092
    rng = np.random.default_rng(5)
    logits = np.round(rng.normal(0, 2, (2, n)), 1).astype(np.float32)
    deltas = rng.normal(0, 0.5, (2, n, 4)).astype(np.float32)
    image_hw = np.array([[128, 128], [96, 120]], np.float32)
    jb, js, jv = jm.proposals(jnp.asarray(logits), jnp.asarray(deltas),
                              jnp.asarray(image_hw), training=False,
                              canvas_hw=(128, 128))
    tb, ts, tv = tm.proposals(t(logits), t(deltas), t(image_hw),
                              canvas_hw=(128, 128))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.asarray(jv).sum() > 20
    close(tb, jb)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ------------------------------------------------------------ whole predict
def predict_both(jcfg, tcfg, seed):
    jm, v, tm = pair(jcfg, tcfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    batch = {"image": rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8),
             "image_hw": np.array([[128, 128], [96, 128]], np.float32)}
    ref = jax.jit(lambda v, bt: jm.predict(v, jax_preprocess(jcfg, bt)))(
        v, batch)
    ref = {k: np.asarray(x) for k, x in ref.items()}
    out = {k: x.numpy() for k, x in make_eval_step(tm, tcfg)(batch).items()}
    assert set(out) == set(ref)
    return out, ref


@pytest.mark.parametrize("pooler", ["roi_align", "roi_align_window"])
def test_tiny_fpn_predict_equals_jax(pooler):
    """``tiny_test_config(use_fpn=True)``; with "roi_align" the JAX package
    pools by its all-level masked sum, with "roi_align_window" (window 24,
    blocked top-k) by its windowed pooler."""
    groups = dict(backbone=dict(use_fpn=True), roi=dict(pooler=pooler))
    if pooler == "roi_align_window":
        groups["roi"]["window"] = 24
        groups["rpn"] = dict(topk_method="blocked")
    out, ref = predict_both(*configs("tiny", **groups), seed=6)
    assert (ref["num_detections"] > 5).all()
    assert_same_detections(out, ref)


def test_coco_r101_fpn_shaped_predict_equals_jax():
    """coco_r101_fpn's serving path (FPN 256, RPN 256 with 3 anchors per
    cell, per-level top-1000, blocked top-k, level-offset NMS, windowed
    pooling, 80 classes) on a 128-px canvas in f32, reduced: ResNet-50
    depth (ResNet-101's features are held in test_torch_fpn_features.py;
    its JAX init alone takes ~16 s here), window 24 (the smallest the fit
    test takes, so the 128-px canvas still bumps RoIs), fc 64."""
    jcfg, tcfg = configs(
        "default",
        data=dict(num_classes=80, canvas_height=128, canvas_width=128),
        backbone=dict(name="resnet50", use_fpn=True),
        rpn=dict(conv_channels=256, topk_method="blocked"),
        roi=dict(pooler="roi_align_window", window=24, fc_dim=64))
    out, ref = predict_both(jcfg, tcfg, seed=7)
    assert (ref["num_detections"] > 5).all()
    assert_same_detections(out, ref)


# ------------------------------------------------------------ weights
def test_fpn_scopes_load_through_from_flax_variables():
    jcfg, tcfg = configs("tiny", backbone=dict(use_fpn=True))
    jm, v, tm = pair(jcfg, tcfg)  # strict load: every name maps
    sd = from_flax_variables(v)
    for i in range(2, 6):
        assert f"fpn.lateral_c{i}.weight" in sd and f"fpn.output_p{i}.bias" in sd
    assert sd["fpn.lateral_c5.weight"].shape == (256, 32, 1, 1)
    assert sd["fpn.output_p3.weight"].shape == (256, 256, 3, 3)
    assert torch.equal(tm.core.fpn.output_p4.weight, sd["fpn.output_p4.weight"])
    assert tm.core.neck_conv is None


def test_fpn_config_errors():
    cfg = preset_config("coco_r101_fpn")
    with pytest.raises(ValueError, match="window"):
        build_model(cfg.replace(roi=dataclasses.replace(cfg.roi, window=32)),
                    device="cpu")
    # The JAX package's other options build; unknown names are refused.
    build_model(cfg.replace(rpn=dataclasses.replace(
        cfg.rpn, topk_method="approx")), device="meta")
    build_model(cfg.replace(roi=dataclasses.replace(
        cfg.roi, pooler="roi_align_packed")), device="meta")
    with pytest.raises(ValueError, match="topk_method"):
        build_model(cfg.replace(rpn=dataclasses.replace(
            cfg.rpn, topk_method="partial")), device="cpu")
    with pytest.raises(ValueError, match="pooler"):
        build_model(cfg.replace(roi=dataclasses.replace(
            cfg.roi, pooler="roi_pool")), device="cpu")
