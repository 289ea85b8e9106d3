"""Mask R-CNN of the PyTorch port against ``tpudet``'s, on the CPU:
``MaskHead`` against Flax through ``from_flax_variables`` (which flips the
transposed convolution's kernel), ``MaskRCNN.loss`` given JAX's sampler
draws and ``predict``'s masks, on ``maskrcnn_tiny`` (single-level c4, the
mask branch pooled at 7) and on its FPN variant with the windowed pooler
at window 56 and the preset's mask pooling size 14.

Weights: Flax's init with ``test_torch_faster_rcnn.random_variables``'s
widened heads and FrozenBN draws, and the mask predictor drawn at std 0.3
(Flax's normal(0.001) would give every mask probability ~0.5 and hide a
fault in the class channel). Batches: ``train_batch``'s planted boxes with
random box-frame crops as ``gt_masks``.

Mask targets: the port's ``mask_targets`` equals tpudet's function run
eagerly (``tests/test_torch_masks.py``), but tpudet's loss runs it under
``jax.jit``, where XLA rounds the sample coordinates differently by an
ulp. A ground-truth box appended to the RoIs at a crop size twice the
target size puts samples exactly between two crop pixels, where the
resampled value is exactly 0.5 and the ulp decides the binary target. The
fixture holds the port's targets to the jitted ones up to such ties
(resampled within ``1e-5`` of 0.5; counted) and then gives the port the
jitted targets, as ``chip_smoke.py`` trains the CPU on the card's
proposals after near-tie flips.

Tolerances (f32): the head within ``1e-5``; the loss terms within
``1e-5`` relative; each gradient within ``1e-4`` of its largest magnitude
plus ``1e-5`` of its own values, plus ``1e-6`` of the model's largest
gradient (as ``tests/test_torch_fpn_train.py``), ``5e-4`` of its largest
magnitude on the FPN variant: there a ReLU of the 14x14 mask head whose
input lies within ~1e-5 of 0 takes the other side in f32 than in exact
arithmetic (a float64 run of the port finds one such unit after conv2 and
one after the deconv), which moves the gradients by up to 2.8e-4 of their
largest magnitude in the port and in tpudet alike; detections as
``assert_same_detections`` and each matched detection's mask within
``1e-5``.
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
    random_variables,
)
from tests.test_torch_faster_rcnn_train import jax_draws, t
from tpudet import config as jconfig
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.models import MaskRCNN as JaxMaskRCNN
from tpudet.models.mask_head import MaskHead as JaxMaskHead
from tpudet.ops import masks as jops
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.models.mask_head import MaskHead
from tpudet_torch.models import mask_rcnn as tmask_rcnn
from tpudet_torch.models.mask_rcnn import MaskRCNN
from tpudet_torch.ops.masks import crop_mask_to_roi
from tpudet_torch.train.step import make_eval_step

torch.set_num_threads(2)
METRICS = ("loss", "rpn_cls_loss", "rpn_box_loss", "det_cls_loss",
           "det_box_loss", "num_pos_anchors", "num_fg_rois", "mask_loss")
PREDICT_STD = 0.3


def mask_configs(variant):
    """maskrcnn_tiny in both packages; "fpn": with the FPN, the windowed
    pooler at window 56 and the mask branch pooled at 14."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.tiny_maskrcnn_config()
        if variant == "fpn":
            cfg = cfg.replace(
                backbone=dataclasses.replace(cfg.backbone, use_fpn=True),
                roi=dataclasses.replace(cfg.roi, pooler="roi_align_window",
                                        window=56),
                mask=dataclasses.replace(cfg.mask, roi_output_size=14))
        out.append(cfg)
    return out


def mask_pair(jcfg, tcfg, seed):
    jm = JaxMaskRCNN(jcfg)
    v = random_variables(jm, seed)
    p = v["params"]["mask_head"]["predict"]
    p["kernel"] = np.random.default_rng(seed).normal(
        0, PREDICT_STD, p["kernel"].shape).astype(np.float32)
    tm = build_model(tcfg, device="cpu")
    assert isinstance(tm, MaskRCNN)
    tm.core.load_state_dict(from_flax_variables(v))  # strict
    return jm, v, tm


def mask_batch(cfg, seed):
    """``train_batch`` with random box-frame crops (about half set)."""
    batch = train_batch(cfg, seed=seed)
    rng = np.random.default_rng(seed + 100)
    m, g = cfg.data.gt_mask_size, cfg.data.max_gt_boxes
    yy, xx = np.mgrid[:m, :m]
    masks = np.zeros((2, g, m, m), np.uint8)
    for i in range(2):
        for j in range(g):
            cy, cx = rng.uniform(0.3, 0.7, 2) * m
            ry, rx = rng.uniform(0.25, 0.5, 2) * m
            masks[i, j] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    batch["gt_masks"] = masks * batch["gt_valid"][..., None, None]
    return batch


# ------------------------------------------------------------------ head
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_head_equals_flax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (6, 7, 7, 16)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jhead = JaxMaskHead(num_classes=5, num_convs=3, channels=12, dtype=jdt)
    v = jax.tree_util.tree_map(
        np.asarray, jhead.init(jax.random.key(1), jnp.asarray(x)))
    v["params"]["predict"]["kernel"] = rng.normal(
        0, PREDICT_STD, v["params"]["predict"]["kernel"].shape
    ).astype(np.float32)
    ref = np.asarray(jhead.apply(v, jnp.asarray(x)))
    head = MaskHead(16, 5, num_convs=3, channels=12,
                    dtype=getattr(torch, dtype))
    sd = from_flax_variables(v)
    head.load_state_dict(sd)
    out = head(t(x))
    assert out.dtype == torch.float32 and out.shape == (6, 14, 14, 5)
    tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(ref).max()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=tol)
    # The converter's flip matters: the unflipped kernel is another
    # function.
    kernel = np.asarray(v["params"]["deconv"]["kernel"])
    sd["deconv.weight"] = torch.from_numpy(
        np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))
    head.load_state_dict(sd)
    assert np.abs(head(t(x)).detach().numpy() - ref).max() > 10 * tol


def test_mask_head_init_draws_flax_distributions():
    head = MaskHead(256, 80).to(torch.float32)
    from tpudet_torch.models.layers import init_module

    init_module(head, torch.Generator().manual_seed(0))
    # variance_scaling(2, "fan_out", "normal"): std sqrt(2 / (9 * 256)) for
    # the 3x3 convs, sqrt(2 / (4 * 256)) for the deconv; normal(0.001).
    for name, std in (("conv1", (2 / (9 * 256)) ** 0.5),
                      ("deconv", (2 / (4 * 256)) ** 0.5),
                      ("predict", 0.001)):
        w = getattr(head, name).weight
        assert float(w.std()) == pytest.approx(std, rel=0.02), name
        assert float(getattr(head, name).bias.abs().max()) == 0.0


# ------------------------------------------------------------------ model
JAX_TARGETS = jax.jit(jax.vmap(jops.mask_targets, in_axes=(0, 0, 0, 0, None)),
                      static_argnums=4)


def jitted_targets(ties):
    """A stand-in for the port's ``mask_targets``: its own targets, held
    to tpudet's jitted ones up to ties at 0.5 (counted in ``ties``), then
    the jitted ones."""
    port_targets = tmask_rcnn.mask_targets

    def targets(gt_masks, gt_boxes, rois, matched, s):
        own = port_targets(gt_masks, gt_boxes, rois, matched, s)
        ref = torch.from_numpy(np.array(JAX_TARGETS(
            gt_masks.numpy(), gt_boxes.numpy(), rois.numpy(),
            matched.numpy(), s)))
        rows = torch.arange(gt_masks.shape[0])[:, None]
        value = crop_mask_to_roi(gt_masks[rows, matched.long()],
                                 gt_boxes[rows, matched.long()], rois, s)
        differ = own != ref
        assert ((value - 0.5).abs()[differ] < 1e-5).all()
        ties.append(int(differ.sum()))
        return ref

    return targets


@pytest.fixture(scope="module", params=["c4", "fpn"])
def run(request):
    """One loss and gradient and one predict of each package."""
    jcfg, tcfg = mask_configs(request.param)
    jm, v, tm = mask_pair(jcfg, tcfg, seed=11)
    batch = mask_batch(tcfg, seed=5)
    rng = jax.random.key(7)

    def loss(params):
        return jm.loss({**v, "params": params}, batch, rng)

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    shapes = tm.draw_shapes(2, batch["image"].shape[1:3])
    draws = jax_draws(rng, 2, shapes["rpn"][1], shapes["roi"][1])
    ties = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmask_rcnn, "mask_targets", jitted_targets(ties))
        total, port_metrics = tm.loss({k: t(x) for k, x in batch.items()},
                                      draws=draws)
    total.backward()
    print(f"{request.param}: {ties[0]} target pixels at 0.5 ties")

    prng = np.random.default_rng(8)
    pbatch = {"image": prng.integers(0, 256, (2, 128, 128, 3),
                                     dtype=np.uint8),
              "image_hw": np.array([[128, 128], [96, 120]], np.float32)}
    ref = jax.jit(lambda v, bt: jm.predict(v, jax_preprocess(jcfg, bt)))(
        v, pbatch)
    out = make_eval_step(tm, tcfg)(pbatch)
    return dict(
        variant=request.param, tm=tm, tcfg=tcfg, batch=batch, draws=draws,
        metrics=({k: float(x) for k, x in metrics.items()},
                 {k: float(x.detach()) for k, x in port_metrics.items()}),
        grads=from_flax_variables({"params": grads}),
        predict=({k: np.asarray(x) for k, x in ref.items()},
                 {k: x.numpy() for k, x in out.items()}))


def test_loss_terms_equal_jax(run):
    ref, port = run["metrics"]
    assert set(port) == set(ref) == set(METRICS)
    for k in ref:
        assert port[k] == pytest.approx(ref[k], rel=1e-5), k
    assert ref["mask_loss"] > 0.1 and ref["num_fg_rois"] > 0


def test_gradients_equal_jax(run):
    tm, ref_grads = run["tm"], run["grads"]
    rel = 5e-4 if run["variant"] == "fpn" else 1e-4
    assert set(n for n, _ in tm.core.named_parameters()) == set(ref_grads)
    floor = 1e-6 * max(float(g.abs().max()) for g in ref_grads.values())
    for name, p in tm.core.named_parameters():
        want = ref_grads[name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=rel * np.abs(want).max() + floor,
                                   err_msg=name)
    # The mask loss reaches the head, and through the pooler the features.
    for name in ("conv1", "deconv", "predict"):
        assert getattr(tm.core.mask_head, name).weight.grad.abs().max() > 0


def test_predict_masks_equal_jax(run):
    ref, out = run["predict"]
    assert set(out) == set(ref)
    s = 2 * run["tcfg"].mask.roi_output_size
    assert out["masks"].shape == (2, 20, s, s)
    assert (ref["num_detections"] > 3).all()
    assert_same_detections(out, ref)
    compared = 0
    for b in range(2):
        for i in range(int(ref["num_detections"][b])):
            k = next(k for k in range(int(ref["num_detections"][b]))
                     if out["classes"][b, k] == ref["classes"][b, i]
                     and abs(out["scores"][b, k] - ref["scores"][b, i]) < 1e-4
                     and np.allclose(out["boxes"][b, k], ref["boxes"][b, i],
                                     rtol=1e-4, atol=1e-3))
            np.testing.assert_allclose(out["masks"][b, k], ref["masks"][b, i],
                                       atol=1e-5)
            compared += 1
        assert (out["masks"][b][~out["valid"][b]] == 0).all()
    assert compared > 6
    # Probabilities spread away from 1/2 (the widened predictor).
    assert np.abs(out["masks"][out["valid"]] - 0.5).max() > 0.2


def test_loss_without_gt_masks_raises(run):
    batch = {k: t(x) for k, x in run["batch"].items() if k != "gt_masks"}
    with pytest.raises(KeyError, match="gt_masks"):
        run["tm"].loss(batch, draws=run["draws"])


def test_alternating_modes_are_refused():
    cfg = tconfig.tiny_maskrcnn_config()
    for flag in ("rpn_only", "det_only"):
        with pytest.raises(ValueError, match="rpn_only/det_only"):
            build_model(cfg.replace(**{flag: True}), device="cpu")
