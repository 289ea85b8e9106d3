"""The port's evaluators (``tpudet_torch/eval/metrics.py``) against the JAX
package's (``tpudet/eval/metrics.py``) on random detections from numpy
seeds: every summary value within 1e-12 (both are numpy; the port's is a
copy)."""

import numpy as np
import pytest

from tpudet.eval import metrics as jm
from tpudet_torch.eval import metrics as tm

TOL = 1e-12


def scene(rng, num_classes, n_gt, n_det, size=200.0, with_flags=True):
    """One image: ground truth of random boxes (some difficult or crowd,
    some with an annotation area) and detections, half of them jittered
    copies of the ground truth, half random."""
    xy = rng.uniform(0, size * 0.8, (n_gt, 2))
    wh = rng.uniform(4, size * 0.4, (n_gt, 2))
    gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    gt_cls = rng.integers(1, num_classes + 1, n_gt)
    near = gt[rng.integers(0, max(n_gt, 1), n_det // 2)] if n_gt else \
        np.zeros((0, 4), np.float32)
    near = near + rng.normal(0, 2, near.shape).astype(np.float32)
    xy = rng.uniform(0, size * 0.8, (n_det - len(near), 2))
    wh = rng.uniform(4, size * 0.4, (n_det - len(near), 2))
    far = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    det = np.concatenate([near, far]).astype(np.float32)
    det_cls = np.concatenate([
        gt_cls[rng.integers(0, max(n_gt, 1), len(near))] if n_gt
        else np.ones(0, int),
        rng.integers(1, num_classes + 1, len(far))])
    # The near copies mostly score above the random boxes; some tie.
    scores = np.concatenate([rng.uniform(0.3, 1.0, len(near)),
                             rng.uniform(0.0, 0.7, len(far))])
    scores[: n_det // 8] = 0.5
    out = dict(pred_boxes=det, pred_scores=scores, pred_classes=det_cls,
               gt_boxes=gt, gt_classes=gt_cls)
    if with_flags:
        out["gt_difficult"] = rng.uniform(0, 1, n_gt) < 0.15
        out["gt_crowd"] = rng.uniform(0, 1, n_gt) < 0.1
    return out


def assert_summaries_equal(port, ref):
    assert set(port) == set(ref)
    main = [v for k, v in ref.items()
            if k.startswith(("mAP", "AP", "recall@")) and not np.isnan(v)]
    assert main and max(main) > 0.05, ref  # the scenes are not trivial
    for k in ref:
        a, b = port[k], ref[k]
        if np.isnan(b):
            assert np.isnan(a), k
        else:
            assert abs(a - b) <= TOL, (k, a, b)


@pytest.mark.parametrize("interpolation", ["11_points", "all_points"])
@pytest.mark.parametrize("mode", ["voc", "coco"])
@pytest.mark.parametrize("area_range", [None, (0.0, 40.0 ** 2)])
def test_detection_evaluator_equals_jax(interpolation, mode, area_range):
    rng = np.random.default_rng(10)
    kw = dict(iou_thresh=0.5, interpolation=interpolation, mode=mode,
              area_range=area_range)
    port, ref = tm.DetectionEvaluator(5, **kw), jm.DetectionEvaluator(5, **kw)
    for i in range(30):
        s = scene(rng, 5, int(rng.integers(0, 12)), int(rng.integers(0, 40)))
        port.add_image(**s)
        ref.add_image(**s)
    assert_summaries_equal(port.summarize(), ref.summarize())
    np.testing.assert_allclose(port.max_recalls(), ref.max_recalls(),
                               atol=TOL, equal_nan=True)


@pytest.mark.parametrize("interpolation", ["11_points", "all_points"])
def test_average_precision_equals_jax(interpolation):
    rng = np.random.default_rng(11)
    for _ in range(20):
        n = int(rng.integers(1, 50))
        recall = np.sort(rng.uniform(0, 1, n))
        precision = rng.uniform(0, 1, n)
        assert abs(tm.average_precision(recall, precision, interpolation)
                   - jm.average_precision(recall, precision,
                                          interpolation)) <= TOL


def test_coco_evaluator_with_crowd_and_areas_equals_jax():
    rng = np.random.default_rng(12)
    port, ref = tm.CocoStyleEvaluator(4), jm.CocoStyleEvaluator(4)
    for _ in range(25):
        s = scene(rng, 4, int(rng.integers(0, 10)), int(rng.integers(0, 30)))
        area = rng.uniform(10, 120, len(s["gt_boxes"])) ** 2
        area[rng.uniform(0, 1, len(area)) < 0.3] = -1.0  # box area
        port.add_image(**s, gt_area=area)
        ref.add_image(**s, gt_area=area)
    assert_summaries_equal(port.summarize(), ref.summarize())


def test_segm_evaluators_equal_jax():
    rng = np.random.default_rng(13)
    mk = dict(iou_type="segm")
    ports = [tm.DetectionEvaluator(3, **mk), tm.CocoStyleEvaluator(3, **mk)]
    refs = [jm.DetectionEvaluator(3, **mk), jm.CocoStyleEvaluator(3, **mk)]
    for _ in range(8):
        s = scene(rng, 3, int(rng.integers(1, 5)), int(rng.integers(1, 8)),
                  size=60.0)
        # Mostly-full masks, so that mask IoU follows box IoU with holes.
        s["pred_masks"] = rng.uniform(0.3, 1, (len(s["pred_boxes"]), 14, 14))
        s["gt_masks"] = (rng.uniform(0, 1, (len(s["gt_boxes"]), 28, 28))
                         > 0.1).astype(np.uint8)
        for p, r in zip(ports, refs):
            p.add_image(**s)
            r.add_image(**s)
    for p, r in zip(ports, refs):
        assert_summaries_equal(p.summarize(), r.summarize())


def test_keypoint_evaluator_equals_jax():
    rng = np.random.default_rng(14)
    sig = (0.1, 0.08, 0.08, 0.12, 0.12)
    port = tm.CocoStyleEvaluator(2, iou_type="keypoints", keypoint_sigmas=sig)
    ref = jm.CocoStyleEvaluator(2, iou_type="keypoints", keypoint_sigmas=sig)
    for _ in range(10):
        s = scene(rng, 2, int(rng.integers(1, 6)), 0, with_flags=False)
        gt = s["gt_boxes"]
        lo, hi = gt[:, None, :2], gt[:, None, 2:]
        gt_kps = np.concatenate([
            lo + rng.uniform(0, 1, (len(gt), 5, 2)) * (hi - lo),
            rng.integers(0, 3, (len(gt), 5, 1))], -1)
        # A detection near each ground truth with keypoints a few pixels
        # off, and one random detection.
        pred = np.concatenate([gt + rng.normal(0, 2, gt.shape), gt[:1] + 40])
        pred_kps = np.concatenate([gt_kps, gt_kps[:1] + 40])
        pred_kps[..., :2] += rng.normal(0, 2, pred_kps[..., :2].shape)
        pred_kps[..., 2] = rng.uniform(0, 1, pred_kps.shape[:2])
        args = dict(pred_boxes=pred.astype(np.float32),
                    pred_scores=rng.uniform(0, 1, len(pred)),
                    pred_classes=np.concatenate([s["gt_classes"],
                                                 s["gt_classes"][:1]]),
                    gt_boxes=gt, gt_classes=s["gt_classes"],
                    pred_keypoints=pred_kps, gt_keypoints=gt_kps)
        port.add_image(**args)
        ref.add_image(**args)
    assert_summaries_equal(port.summarize(), ref.summarize())


def test_proposal_recall_equals_jax():
    rng = np.random.default_rng(15)
    kw = dict(iou_thresholds=(0.5, 0.7), topk=(10, 30, 100))
    port, ref = tm.ProposalRecallEvaluator(**kw), jm.ProposalRecallEvaluator(**kw)
    for _ in range(20):
        s = scene(rng, 1, int(rng.integers(0, 10)), int(rng.integers(0, 120)))
        args = (s["pred_boxes"], s["pred_scores"], None, s["gt_boxes"], None,
                s["gt_difficult"], s["gt_crowd"])
        port.add_image(*args)
        ref.add_image(*args)
    assert_summaries_equal(port.summarize(), ref.summarize())
