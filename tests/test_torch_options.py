"""The JAX package's remaining options in the PyTorch port, on the CPU,
each against tpudet's same option: ``rpn.topk_method="approx"`` and the
``crop_and_resize`` pooler.

* approx: the JAX package's ``lax.approx_max_k`` is ``lax.top_k`` on its
  CPU backend, and the port takes "approx" to mean its exact top-k: the
  predict equals tpudet's approx predict, and the port's exact predict bit
  for bit;
* ``crop_and_resize`` (TF's convention, plain PyTorch): the function equals
  tpudet's with its extrapolation, and its gradient equals ``jax.vjp``'s;
  one train step's loss and gradients equal tpudet's given JAX's draws
  (the poolers' features and predicts: ``test_torch_options_poolers.py``);
* the fields the port accepts and does not read warn when set.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_deformable_detr_train import train_batch
from tests.test_torch_faster_rcnn import (
    assert_same_detections,
    configs,
    pair,
)
from tests.test_torch_faster_rcnn_train import jax_draws, t
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.ops.roi_align import crop_and_resize as jax_crop_and_resize
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.ops.roi_align import crop_and_resize, crop_and_resize_batched
from tpudet_torch.train.step import make_eval_step

torch.set_num_threads(2)
ROUTED = ("roi_align_gather", "roi_align_pallas", "roi_align_packed")


def uint8_batch(seed=7):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8),
            "image_hw": np.array([[128, 128], [96, 128]], np.float32)}


def predicts(jm, v, jcfg, tm, tcfg, batch):
    ref = jax.jit(lambda v, bt: jm.predict(v, jax_preprocess(jcfg, bt)))(
        v, batch)
    out = make_eval_step(tm, tcfg)(batch)
    return ({k: x.numpy() for k, x in out.items()},
            {k: np.asarray(x) for k, x in ref.items()})


def same_weights(tm, tcfg):
    """A model of ``tcfg`` holding ``tm``'s weights."""
    other = build_model(tcfg, device="cpu")
    other.core.load_state_dict(tm.core.state_dict())
    return other


@pytest.mark.parametrize("fpn", [False, True], ids=["c4", "fpn"])
def test_approx_predict_equals_jax_approx_and_port_exact(fpn):
    groups = {"rpn": {"topk_method": "approx"}}
    if fpn:
        groups["backbone"] = {"use_fpn": True}
    jcfg, tcfg = configs("tiny", **groups)
    jm, v, tm = pair(jcfg, tcfg, seed=6)
    batch = uint8_batch()
    out, ref = predicts(jm, v, jcfg, tm, tcfg, batch)
    assert (ref["num_detections"] > 5).all()
    assert_same_detections(out, ref)
    exact_cfg = tcfg.replace(rpn=dataclasses.replace(tcfg.rpn,
                                                     topk_method="exact"))
    exact = make_eval_step(same_weights(tm, exact_cfg), exact_cfg)(batch)
    for k, x in exact.items():
        assert torch.equal(torch.from_numpy(out[k]), x), k


@pytest.mark.parametrize("crop,extrapolation", [(7, 0.0), (14, -1.5),
                                                (1, 0.25)])
def test_crop_and_resize_and_its_gradient_equal_jax(crop, extrapolation):
    rng = np.random.default_rng(crop)
    feats = rng.normal(0, 1, (9, 13, 5)).astype(np.float32)
    # Inside, straddling each edge, wholly outside, flipped (x2 < x1), a
    # point.
    boxes = np.array([[1.0, 2.0, 7.5, 6.0], [-3.0, -2.0, 4.0, 5.0],
                      [9.0, 5.0, 15.0, 11.0], [14.0, 10.0, 20.0, 12.0],
                      [6.0, 7.0, 2.0, 1.0], [4.0, 4.0, 4.0, 4.0]],
                     np.float32)
    ref = jax_crop_and_resize(jnp.asarray(feats), jnp.asarray(boxes), crop,
                              extrapolation)
    x = t(feats).requires_grad_(True)
    out = crop_and_resize(x, t(boxes), crop, extrapolation)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    assert (out.detach().numpy() == extrapolation).any()
    g = rng.normal(0, 1, out.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jax_crop_and_resize(f, jnp.asarray(boxes),
                                                   crop, extrapolation),
                     jnp.asarray(feats))
    (want,) = vjp(jnp.asarray(g))
    out.backward(t(g))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # The batched form: each box from its own image.
    two = torch.stack([t(feats), -t(feats)])
    index = torch.tensor([0, 1, 1, 0, 1, 0], dtype=torch.int32)
    got = crop_and_resize_batched(two, t(boxes), index, crop, extrapolation)
    for k in range(len(boxes)):
        want_k = crop_and_resize(two[index[k]], t(boxes[k:k + 1]), crop,
                                 extrapolation)
        assert torch.equal(got[k:k + 1], want_k)


def test_crop_and_resize_train_step_equals_jax():
    """One loss and gradient of the tiny c4 model with
    ``pooler="crop_and_resize"``, given JAX's sampler draws: the metrics
    within 1e-5 relative, the gradients within 1e-4 of each tensor's
    largest (the RoI head's reach the backbone through the crops)."""
    jcfg, tcfg = configs("tiny", roi={"pooler": "crop_and_resize"})
    jm, v, tm = pair(jcfg, tcfg, seed=11)
    batch = train_batch(tcfg, seed=5)
    rng = jax.random.key(7)

    def loss(params):
        return jm.loss({**v, "params": params}, batch, rng)

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    grads = from_flax_variables({"params": grads})
    shapes = tm.draw_shapes(2, batch["image"].shape[1:3])
    draws = jax_draws(rng, 2, shapes["rpn"][1], shapes["roi"][1])
    total, port = tm.loss({k: t(x) for k, x in batch.items()}, draws=draws)
    for k, x in metrics.items():
        assert float(port[k].detach()) == pytest.approx(float(x), rel=1e-5), k
    total.backward()
    floor = 1e-6 * max(float(g.abs().max()) for g in grads.values())
    for name, p in tm.core.named_parameters():
        want = grads[name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-4 * np.abs(want).max() + floor,
                                   err_msg=name)
    assert tm.core.det_head.fc1.weight.grad.abs().max() > 0


@pytest.mark.parametrize("key,value", [("rpn.topk_recall_target", 0.9),
                                       ("roi.window_batched", False),
                                       ("roi.pooler_chunk", 64),
                                       ("roi.mxu_chunk_budget_mb", 8.0)])
def test_fields_the_port_does_not_read_warn_when_set(key, value):
    """The four fields kept for ``--set`` parity (``config.NOT_READ``) are
    set as tpudet sets them, with a warning that they change nothing."""
    from tpudet import config as jconfig
    from tpudet_torch import config as tconfig

    assert key in tconfig.NOT_READ
    with pytest.warns(UserWarning, match=f"{key}: the port accepts"):
        cfg = tconfig.apply_overrides(tconfig.tiny_test_config(),
                                      {key: value})
    group, field = key.split(".")
    ref = jconfig.apply_overrides(jconfig.tiny_test_config(), {key: value})
    assert getattr(getattr(cfg, group), field) == value == getattr(
        getattr(ref, group), field)
