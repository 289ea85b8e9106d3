"""FPN Faster R-CNN training of the PyTorch port against ``tpudet``'s, on
the CPU: ``FasterRCNN.loss`` on ``tiny_test_config(use_fpn=True)`` in both
FPN poolers, ``roi_align`` (each RoI at its FPN-paper level) and
``roi_align_window`` at window 56 (the level bumped until the RoI fits the
window, as coco_r101_fpn trains), with weights carried over by
``from_flax_variables`` and JAX's sampler draws handed to the port, as
``tests/test_torch_faster_rcnn_train.py`` holds the C4 path.

The FPN pieces that ``loss`` reaches: the RPN targets over the FPN
anchors (p2..p6), the training-mode FPN proposals (top-k per level,
level-offset NMS, ``post_nms_topk_train``), the sampler draws' shapes on
the FPN canvas, and the pooling of the sampled RoIs at their levels, whose
gradient reaches p2..p5 (the port's CPU path differentiates through the
plain pooler; tpudet's through its masked sum over the levels).

Tolerances (f32), those of the C4 test: training proposals' boxes within
``1e-4`` with equal validity; sampled indices, positives, validity, target
classes and matched ground truth equal; each loss term within ``1e-5``
relative; each parameter's gradient within ``1e-4`` of its largest
magnitude plus ``1e-5`` of its own values, plus ``1e-6`` of the model's
largest gradient (the conv biases before a GroupNorm have zero gradient in
exact arithmetic: rounding noise on both sides). Last, ``chip_smoke.py``'s
FPN learning check on the CPU: the port falls below the card's bar.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_deformable_detr_train import train_batch
from tests.test_torch_faster_rcnn import configs, pair
from tests.test_torch_faster_rcnn_train import (
    METRICS,
    jax_draws,
    jax_targets,
    recording,
    t,
)
from tests.test_torch_fpn_learning import STEPS, fall, recipe
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.ops.roi_align import fpn_assign_levels
from tpudet_torch.train.state import create_train_state
from tpudet_torch.train.step import make_train_step

torch.set_num_threads(2)


def fpn_configs(pooler, window=56, **groups):
    """tiny_test_config(use_fpn=True) with ``pooler`` in both packages."""
    return configs("tiny", backbone=dict(use_fpn=True),
                   roi=dict(pooler=pooler, window=window), **groups)


@pytest.fixture(scope="module", params=["roi_align", "roi_align_window"])
def run(request):
    """One loss and gradient of each package for one pooler, with JAX's
    draws in the port, and both packages' targets."""
    jcfg, tcfg = fpn_configs(request.param)
    jm, v, tm = pair(jcfg, tcfg, seed=11)
    batch = train_batch(tcfg, seed=5)
    rng = jax.random.key(7)

    def loss(params):
        return jm.loss({**v, "params": params}, batch, rng)

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    targets = jax.jit(functools.partial(jax_targets, jm))(v, batch, rng)
    shapes = tm.draw_shapes(2, batch["image"].shape[1:3])
    draws = jax_draws(rng, 2, shapes["rpn"][1], shapes["roi"][1])
    seen = recording(tm, ("_rpn_targets_single", "proposals",
                          "_roi_targets_single", "_pool_batch"))
    total, port_metrics = tm.loss({k: t(x) for k, x in batch.items()},
                                  draws=draws)
    total.backward()
    return dict(pooler=request.param, tm=tm, jm=jm, seen=seen,
                targets=targets, shapes=shapes,
                metrics=({k: float(x) for k, x in metrics.items()},
                         {k: float(x.detach()) for k, x in port_metrics.items()}),
                grads=from_flax_variables({"params": grads}))


def test_draw_shapes_cover_the_fpn_anchors_and_proposals(run):
    tm, jm = run["tm"], run["jm"]
    anchors = jm.anchor_boxes((128, 128))
    # p2..p6 of a 128-px canvas, 3 anchors per cell.
    assert run["shapes"]["rpn"] == (2, anchors.shape[0]) == (2, 4092)
    assert run["shapes"]["roi"] == (2, tm.cfg.rpn.post_nms_topk_train
                                    + tm.cfg.data.max_gt_boxes)


def test_targets_equal_jax(run):
    (rpn, props, roi), seen = run["targets"], run["seen"]
    for got, want in zip(seen["_rpn_targets_single"][:3], rpn[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(seen["_rpn_targets_single"][3].numpy(),
                               np.asarray(rpn[3]), rtol=1e-5, atol=1e-5)
    assert int(np.asarray(rpn[1]).sum()) > 0
    boxes, _, valid = seen["proposals"]
    np.testing.assert_array_equal(valid.numpy(), np.asarray(props[2]))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(props[0]), rtol=1e-4,
                               atol=1e-4)
    assert boxes.shape == (2, 128, 4)  # post_nms_topk_train
    got = seen["_roi_targets_single"]
    # sampled boxes, target classes, target deltas, is_fg, valid, matched GT
    for i in (1, 3, 4, 5):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(roi[i]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(roi[0]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(roi[2]), rtol=1e-4,
                               atol=1e-4)
    assert int(np.asarray(roi[3]).sum()) > 0
    # The sampled RoIs were pooled once, at their levels of p2..p5.
    assert run["seen"]["_pool_batch"].shape[:2] == (2, 32)
    fit = run["tm"].cfg.roi.window if run["pooler"] == "roi_align_window" else 0
    levels = fpn_assign_levels(got[0], fit_window=fit)
    assert ((levels >= 2) & (levels <= 5)).all()


def test_loss_terms_equal_jax(run):
    ref, port = run["metrics"]
    assert set(port) == set(ref) == set(METRICS["default"])
    for k in ref:
        assert port[k] == pytest.approx(ref[k], rel=1e-5), k
    assert ref["loss"] > 0.5


def test_gradients_equal_jax(run):
    tm, ref_grads = run["tm"], run["grads"]
    names = [n for n, _ in tm.core.named_parameters()]
    assert set(names) == set(ref_grads)
    floor = 1e-6 * max(float(g.abs().max()) for g in ref_grads.values())
    for name, p in tm.core.named_parameters():
        want = ref_grads[name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-4 * np.abs(want).max() + floor,
                                   err_msg=name)
    # The detection loss reaches the FPN through the pooler.
    assert tm.core.det_head.cls.weight.grad.abs().max() > 0
    assert tm.core.fpn.output_p2.weight.grad.abs().max() > 0
    assert tm.core.rpn_head.objectness.weight.grad.abs().max() > 0


def test_port_falls_below_the_card_bar():
    """``chip_smoke.py``'s FPN learning check on the CPU: the port's own
    init and sampler stream, the card's recipe and bar
    (``tests/test_torch_fpn_learning.py``)."""
    tcfg, _, batch = recipe()
    model = build_model(tcfg, device="cpu")
    state = create_train_state(model, tcfg.train, seed=0, device="cpu")
    step = make_train_step(model, tcfg, device="cpu")
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    print(f"the port's FPN learning fall on the CPU: {fall(losses):.4f}x")
    assert fall(losses) < chip_smoke.FPN_LEARNING_RATIO
