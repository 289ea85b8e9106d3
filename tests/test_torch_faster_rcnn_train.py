"""Faster R-CNN training of the PyTorch port against ``tpudet``'s, on the
CPU: the RPN and detection losses, and ``FasterRCNN.loss`` on
``tiny_test_config`` in its default, ``rpn_only`` and ``det_only`` modes,
with weights carried over by ``from_flax_variables``.

The samplers' uniforms are JAX's: the key chain of ``FasterRCNN.loss``
(``split(rng) -> split(., B)`` per stage, ``split(key)`` in the sampler)
is rebuilt here and its draws handed to the port as ``draws``, so both
packages sample the same anchors and RoIs.

Tolerances (f32): the loss functions within ``1e-6`` relative; training
proposals' boxes within ``1e-4`` with equal validity; sampled indices,
positives, validity and target classes equal; each loss term within
``1e-5`` relative; each parameter's gradient within ``1e-4`` of its largest
magnitude plus ``1e-5`` of its own values (the frameworks sum convolutions
and dense layers in other orders), plus ``1e-6`` of the model's largest
gradient (the conv biases before a GroupNorm have zero gradient in exact
arithmetic: rounding noise on both sides).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_deformable_detr_train import train_batch
from tests.test_torch_faster_rcnn import configs, pair
from tpudet.models.faster_rcnn import DetectorCore as JaxCore
from tpudet.train import losses as jlosses
from tpudet_torch.train import losses as tlosses

torch.set_num_threads(2)

METRICS = {
    "default": ("loss", "rpn_cls_loss", "rpn_box_loss", "det_cls_loss",
                "det_box_loss", "num_pos_anchors", "num_fg_rois"),
    "rpn_only": ("loss", "rpn_cls_loss", "rpn_box_loss", "num_pos_anchors"),
    "det_only": ("loss", "det_cls_loss", "det_box_loss", "num_fg_rois"),
}


def t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ losses
def test_smooth_l1_equals_jax():
    rng = np.random.default_rng(0)
    pred, target = rng.normal(0, 1, (2, 50, 4)).astype(np.float32), \
        rng.normal(0, 1, (2, 50, 4)).astype(np.float32)
    for beta in (1.0 / 9.0, 1.0, 0.0):
        np.testing.assert_allclose(
            tlosses.smooth_l1(t(pred), t(target), beta).numpy(),
            np.asarray(jlosses.smooth_l1(jnp.asarray(pred), jnp.asarray(target),
                                         beta)), rtol=1e-6, atol=1e-7)


def test_rpn_losses_equal_jax():
    rng = np.random.default_rng(1)
    b, k = 3, 40
    logits = rng.normal(0, 2, (b, k)).astype(np.float32)
    logits[0, 0] = 0.0
    deltas = rng.normal(0, 0.5, (b, k, 4)).astype(np.float32)
    target = rng.normal(0, 0.5, (b, k, 4)).astype(np.float32)
    is_pos = rng.uniform(size=(b, k)) < 0.3
    valid = rng.uniform(size=(b, k)) < 0.8
    valid[2] = False  # nothing sampled: 0, not NaN
    ref = jax.vmap(functools.partial(jlosses.rpn_losses, box_weight=2.0))(
        *(jnp.asarray(x) for x in (logits, deltas, target, is_pos, valid)))
    out = tlosses.rpn_losses(t(logits), t(deltas), t(target), t(is_pos),
                             t(valid), box_weight=2.0)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
    assert float(out[0][2]) == 0.0 and float(out[1][2]) == 0.0


@pytest.mark.parametrize("c_box", [3, 1], ids=["per_class", "agnostic"])
def test_detection_losses_equal_jax(c_box):
    rng = np.random.default_rng(2)
    b, r, c = 2, 30, 3
    logits = rng.normal(0, 2, (b, r, c + 1)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (b, r, c_box, 4)).astype(np.float32)
    classes = rng.integers(0, c + 1, (b, r)).astype(np.int32)
    target = rng.normal(0, 0.5, (b, r, 4)).astype(np.float32)
    is_fg = classes > 0
    valid = rng.uniform(size=(b, r)) < 0.9
    ref = jax.vmap(jlosses.detection_losses)(
        *(jnp.asarray(x) for x in (logits, deltas, classes, target, is_fg,
                                   valid)))
    out = tlosses.detection_losses(t(logits), t(deltas), t(classes), t(target),
                                   t(is_fg), t(valid))
    for o, rf in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(rf), rtol=1e-6,
                                   atol=1e-7)
    assert (out[1] > 0).all()


# -------------------------------------------------------------- the model
def jax_draws(rng, b, n_rpn, n_roi):
    """The uniforms ``FasterRCNN.loss`` draws from ``rng``, as the port's
    ``draws``: ``split(rng) -> (rpn, roi)``, ``split(stage, b)`` per image,
    ``split(key) -> (pos, tie)`` in the sampler."""
    rng_rpn, rng_roi = jax.random.split(rng)

    def stage(key, n):
        def one(k):
            pos, tie = jax.random.split(k)
            return (jax.random.uniform(pos, (n,)), jax.random.uniform(tie, (n,)))

        pos, tie = jax.vmap(one)(jax.random.split(key, b))
        return t(pos), t(tie)

    return {"rpn": stage(rng_rpn, n_rpn), "roi": stage(rng_roi, n_roi)}


def jax_targets(jm, v, batch, rng):
    """JAX's RPN samples, training proposals and RoI samples for ``batch``,
    as ``FasterRCNN.loss`` computes them."""
    images = batch["image"]
    b = images.shape[0]
    anchors = jm.anchor_boxes(images.shape[1:3])
    feats = jm.core.apply(v, images, method=JaxCore.features)
    logits, deltas = jm.core.apply(v, feats, method=JaxCore.rpn)
    rng_rpn, rng_roi = jax.random.split(rng)
    rpn = jax.vmap(functools.partial(jm._rpn_targets_single, anchors))(
        batch["gt_boxes"], batch["gt_valid"], batch["image_hw"],
        jax.random.split(rng_rpn, b))
    props = jm.proposals(logits, deltas, batch["image_hw"], training=True,
                         canvas_hw=images.shape[1:3])
    roi = jax.vmap(jm._roi_targets_single)(
        props[0], props[2], batch["gt_boxes"], batch["gt_classes"],
        batch["gt_valid"], jax.random.split(rng_roi, b))
    return rpn, props, roi


def recording(model, names):
    """Wrap the model's ``names`` methods to keep their last outputs."""
    seen = {}
    for name in names:
        original = getattr(model, name)

        def wrapped(*args, _original=original, _name=name, **kw):
            seen[_name] = _original(*args, **kw)
            return seen[_name]

        setattr(model, name, wrapped)
    return seen


@pytest.fixture(scope="module", params=["default", "rpn_only", "det_only"])
def run(request):
    """One loss and gradient of each package for one training mode, with
    JAX's draws in the port, and both packages' targets."""
    mode = request.param
    flags = {"rpn_only": mode == "rpn_only", "det_only": mode == "det_only"}
    jcfg, tcfg = configs("tiny", **flags)
    jm, v, tm = pair(jcfg, tcfg, seed=11)
    batch = train_batch(tcfg, seed=5)
    rng = jax.random.key(7)

    def loss(params):
        return jm.loss({**v, "params": params}, batch, rng)

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    from tpudet_torch.models.import_weights import from_flax_variables

    targets = jax.jit(functools.partial(jax_targets, jm))(v, batch, rng)
    shapes = tm.draw_shapes(2, batch["image"].shape[1:3])
    draws = jax_draws(rng, 2, shapes["rpn"][1], shapes["roi"][1])
    seen = recording(tm, ("_rpn_targets_single", "proposals",
                          "_roi_targets_single"))
    total, port_metrics = tm.loss({k: t(x) for k, x in batch.items()},
                                  draws=draws)
    total.backward()
    return dict(mode=mode, tm=tm, seen=seen, targets=targets,
                metrics=({k: float(x) for k, x in metrics.items()},
                         {k: float(x.detach()) for k, x in port_metrics.items()}),
                grads=from_flax_variables({"params": grads}))


def test_targets_equal_jax(run):
    (rpn, props, roi), seen = run["targets"], run["seen"]
    if run["mode"] != "det_only":
        for got, want in zip(seen["_rpn_targets_single"][:3], rpn[:3]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(seen["_rpn_targets_single"][3].numpy(),
                                   np.asarray(rpn[3]), rtol=1e-5, atol=1e-5)
        assert int(np.asarray(rpn[1]).sum()) > 0
    if run["mode"] == "rpn_only":
        assert "proposals" not in seen
        return
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


def test_loss_terms_equal_jax(run):
    ref, port = run["metrics"]
    assert set(port) == set(ref) == set(METRICS[run["mode"]])
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
    rpn_grad = tm.core.rpn_head.objectness.weight.grad
    det_grad = tm.core.det_head.cls.weight.grad
    if run["mode"] == "det_only":  # proposals only: no gradient to the RPN
        assert rpn_grad is None or not rpn_grad.any()
    else:
        assert rpn_grad.abs().max() > 0
    if run["mode"] == "rpn_only":
        assert det_grad is None
    else:
        assert det_grad.abs().max() > 0
