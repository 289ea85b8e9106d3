"""Soft-NMS of the PyTorch port against ``tpudet``'s, on the CPU:
``soft_nms`` and ``batched_soft_nms`` on fuzzed boxes for both methods
(one image and a batch against ``jax.vmap``), the validity mask, the prune
threshold and the empty case, the soft route of ``class_aware_select``,
and the ``nms_method`` knob of Faster R-CNN (``roi``), RetinaNet and FCOS
on their tiny predicts.

Tolerances: indices and validity exactly equal; rescored scores within
1e-6 (the Gaussian decay's ``exp`` may round an ulp apart); detections as
each family's test file holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_faster_rcnn import assert_same_detections, configs, pair
from tpudet.kernels import class_aware_select as jax_select
from tpudet.ops import nms as jnms
from tpudet_torch.kernels import class_aware_select
from tpudet_torch.ops import nms as tnms

torch.set_num_threads(2)
SCORE_ATOL = 1e-6


def fuzz(seed, b, n, classes=5):
    """Clustered boxes (overlaps of every IoU), scores with exact ties, a
    validity mask and class ids."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(40, 260, (b, 6, 2))
    pick = rng.integers(0, 6, (b, n))
    c = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(
        0, 12, (b, n, 2))
    wh = rng.uniform(10, 70, (b, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    scores[:, 1::7] = scores[:, ::7][:, :scores[:, 1::7].shape[1]]  # ties
    valid = rng.uniform(size=(b, n)) > 0.15
    cls = rng.integers(1, classes + 1, (b, n)).astype(np.int32)
    return boxes, scores, valid, cls


def assert_same(port, ref):
    idx, scores, valid = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(port[0].numpy(), idx)
    np.testing.assert_array_equal(port[2].numpy(), valid)
    np.testing.assert_allclose(port[1].numpy(), scores, rtol=0,
                               atol=SCORE_ATOL)
    assert port[0].dtype == torch.int32 and port[2].dtype == torch.bool


@pytest.mark.parametrize("method", ["linear", "gaussian"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_soft_nms_one_image_equals_jax(method, seed):
    boxes, scores, valid, _ = fuzz(seed, 1, 300)
    kw = dict(method=method, sigma=0.5, prune_threshold=0.3)
    ref = jnms.soft_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.3,
                        250, valid_mask=jnp.asarray(valid[0]), **kw)
    out = tnms.soft_nms(torch.from_numpy(boxes[0]),
                        torch.from_numpy(scores[0]), 0.3, 250,
                        valid_mask=torch.from_numpy(valid[0]), **kw)
    assert_same(out, ref)
    assert 10 < int(out[2].sum()) < 200  # the prune threshold ends it early


@pytest.mark.parametrize("method", ["linear", "gaussian"])
def test_batched_soft_nms_over_a_batch_equals_jax_vmap(method):
    boxes, scores, valid, cls = fuzz(3, 4, 400, classes=7)
    offset = 4096.0

    def one(b, s, c, v):
        return jnms.batched_soft_nms(b, s, c, 0.5, 100, method=method,
                                     sigma=0.3, valid_mask=v,
                                     prune_threshold=0.01,
                                     coordinate_offset=offset)

    ref = jax.jit(jax.vmap(one))(*(jnp.asarray(x)
                                   for x in (boxes, scores, cls, valid)))
    out = tnms.batched_soft_nms(
        *(torch.from_numpy(x) for x in (boxes, scores, cls)), 0.5, 100,
        method=method, sigma=0.3, valid_mask=torch.from_numpy(valid),
        prune_threshold=0.01, coordinate_offset=offset)
    assert_same(out, ref)


def test_no_valid_entry_gives_an_all_invalid_output():
    boxes, scores, _, _ = fuzz(4, 1, 50)
    valid = np.zeros(50, bool)
    for method in ("linear", "gaussian"):
        idx, s, v = tnms.soft_nms(torch.from_numpy(boxes[0]),
                                  torch.from_numpy(scores[0]), 0.5, 20,
                                  method=method,
                                  valid_mask=torch.from_numpy(valid))
        assert not v.any() and (idx == 0).all() and (s == 0).all()
        ref = jnms.soft_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                            0.5, 20, method=method,
                            valid_mask=jnp.asarray(valid))
        assert_same((idx, s, v), ref)


def test_more_outputs_than_boxes_and_the_suffix_rule():
    """``max_outputs`` above N: the picks past the live entries are
    invalid, point at 0 with score 0 and form a suffix; the valid scores
    never rise."""
    boxes, scores, valid, _ = fuzz(5, 1, 12)
    out = tnms.soft_nms(torch.from_numpy(boxes[0]),
                        torch.from_numpy(scores[0]), 0.4, 20,
                        method="linear", valid_mask=torch.from_numpy(valid[0]))
    ref = jnms.soft_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.4, 20,
                        method="linear", valid_mask=jnp.asarray(valid[0]))
    assert_same(out, ref)
    v = out[2].numpy()
    n = int(v.sum())
    assert n == int(valid[0].sum()) and v[:n].all() and not v[n:].any()
    s = out[1].numpy()
    assert (np.diff(s[:n]) <= 0).all()


def test_unknown_method_is_refused():
    with pytest.raises(ValueError, match="linear.*gaussian"):
        tnms.soft_nms(torch.zeros(3, 4), torch.zeros(3), 0.5, 2,
                      method="hard")
    with pytest.raises(ValueError, match="nms_method"):
        class_aware_select(torch.zeros(3, 4), torch.zeros(3),
                           torch.ones(3, dtype=torch.int32), 0.5, 2,
                           method="soft")


@pytest.mark.parametrize("method", ["soft_linear", "soft_gaussian", "hard"])
def test_class_aware_select_equals_jax(method):
    """The soft route returns the decayed scores, the hard route the
    originals; batched over images in the port, one image in tpudet."""
    boxes, scores, valid, cls = fuzz(6, 2, 500, classes=20)
    out = class_aware_select(
        *(torch.from_numpy(x) for x in (boxes, scores, cls)), 0.5, 100,
        method=method, sigma=0.5, prune_threshold=0.05,
        valid_mask=torch.from_numpy(valid), coordinate_offset=4096.0)
    for b in range(2):
        ref = jax_select(*(jnp.asarray(x[b]) for x in (boxes, scores, cls)),
                         0.5, 100, method=method, sigma=0.5,
                         prune_threshold=0.05,
                         valid_mask=jnp.asarray(valid[b]), use_pallas=False,
                         coordinate_offset=4096.0)
        assert_same([x[b] for x in out], ref)


# ----------------------------------------------------------------- models
@pytest.mark.parametrize("method", ["soft_gaussian", "soft_linear"])
def test_faster_rcnn_soft_nms_predict_equals_jax(method):
    from tpudet.data.preprocess import device_preprocess as jax_preprocess
    from tpudet_torch.train.step import make_eval_step

    jcfg, tcfg = configs("tiny", roi=dict(nms_method=method))
    jm, v, tm = pair(jcfg, tcfg, seed=6)
    rng = np.random.default_rng(7)
    batch = {"image": rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8),
             "image_hw": np.array([[128, 128], [96, 128]], np.float32)}
    ref = jax.jit(lambda v, bt: jm.predict(v, jax_preprocess(jcfg, bt)))(
        v, batch)
    ref = {k: np.asarray(x) for k, x in ref.items()}
    out = {k: x.numpy() for k, x in make_eval_step(tm, tcfg)(batch).items()}
    assert (ref["num_detections"] > 5).all()
    assert_same_detections(out, ref)
    # Soft-NMS keeps overlapping boxes that greedy NMS drops, at decayed
    # scores.
    hard_cfg = tcfg.replace(roi=dataclasses.replace(tcfg.roi,
                                                    nms_method="hard"))
    tm.cfg = hard_cfg
    hard = {k: x.numpy()
            for k, x in make_eval_step(tm, hard_cfg)(batch).items()}
    assert (out["num_detections"] >= hard["num_detections"]).all()


@pytest.mark.parametrize("family", ["retinanet", "fcos"])
def test_one_stage_soft_nms_predict_equals_jax(family):
    if family == "retinanet":
        from tests.test_torch_retinanet import (
            assert_same_detections as same, configs as fconfigs, pair as
            fpair, predict_both, uint8_batch)
        from tpudet.models import RetinaNet as JaxModel

        jcfg, tcfg = fconfigs(nms_method="soft_gaussian")
        jm = JaxModel(jcfg)
        v, tm = fpair(jm, jcfg, tcfg, seed=5)
    else:
        from tests.test_torch_fcos import configs as fconfigs, pair as fpair
        from tests.test_torch_retinanet import (
            assert_same_detections as same, predict_both, uint8_batch)
        from tpudet.models import FCOS as JaxModel

        jcfg, tcfg = fconfigs(nms_method="soft_linear", score_thresh=0.0)
        jm = JaxModel(jcfg)
        v, tm = fpair(jm, tcfg, seed=5)
    out, ref = predict_both(jm, v, jcfg, tm, tcfg, uint8_batch(6))
    assert (ref["num_detections"] > 5).all()
    same(out, ref)
