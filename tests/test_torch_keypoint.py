"""Keypoint R-CNN of the PyTorch port against ``tpudet``'s, on the CPU: the
keypoint head against Flax's (its 4x4 stride-2 transposed convolution
overlaps), the constructor's checks, the keypoint targets (grid indices,
keypoints on cell edges, unlabeled and outside ones), ``keypoint_loss``
against JAX's and its closed form, ``loss`` and its gradients given JAX's
sampler draws, ``predict``'s keypoints (and the first maximum of a tied
heatmap), ``prepare_example``'s ``gt_keypoints`` and the train-time flip
with its pair swap given JAX's flip draw, on ``keypoint_tiny`` (c4, the
branch pooled at 7) and on its FPN variant with the windowed pooler at
window 56 and the preset's pooling size 14.

Weights: Flax's init with ``test_torch_faster_rcnn.random_variables``'s
widened heads. Batches: ``train_batch``'s planted boxes with five
keypoints in each box, a fifth of them unlabeled (v = 0) and a fifth
labeled but hidden (v = 1).

Tolerances (f32): the head within ``1e-5``; targets, validity and
``rescale``'s, ``prepare_example``'s and the flip's keypoints exactly
equal; the loss within ``1e-6`` relative; every loss term within ``1e-5``
relative; each gradient within ``1e-4`` of its largest magnitude plus
``1e-5`` of its own values plus ``1e-6`` of the model's largest gradient
(as ``tests/test_torch_fpn_train.py``); detections as
``assert_same_detections``, and each matched detection's keypoints within
``1e-3`` px (the box tolerance) and their scores within ``1e-5``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_data_preprocess import jax_draws as augment_draws
from tests.test_torch_deformable_detr_train import train_batch
from tests.test_torch_faster_rcnn import (
    assert_same_detections,
    random_variables,
)
from tests.test_torch_faster_rcnn_train import jax_draws, t
from tpudet import config as jconfig
from tpudet.data import preprocess as jpre
from tpudet.models import KeypointRCNN as JaxKeypointRCNN
from tpudet.models.keypoint_head import KeypointHead as JaxKeypointHead
from tpudet.train import losses as jlosses
from tpudet_torch import config as tconfig
from tpudet_torch.data import preprocess as tpre
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.models.keypoint_head import KeypointHead
from tpudet_torch.models.keypoint_rcnn import KeypointRCNN
from tpudet_torch.train import losses as tlosses
from tpudet_torch.train.step import make_eval_step

torch.set_num_threads(2)
METRICS = ("loss", "rpn_cls_loss", "rpn_box_loss", "det_cls_loss",
           "det_box_loss", "num_pos_anchors", "num_fg_rois", "keypoint_loss")


def keypoint_configs(variant):
    """keypoint_tiny in both packages; "fpn": with the FPN, the windowed
    pooler at window 56 and the branch pooled at 14."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.tiny_keypoint_config()
        if variant == "fpn":
            cfg = cfg.replace(
                backbone=dataclasses.replace(cfg.backbone, use_fpn=True),
                roi=dataclasses.replace(cfg.roi, pooler="roi_align_window",
                                        window=56),
                keypoint=dataclasses.replace(cfg.keypoint,
                                             roi_output_size=14))
        out.append(cfg)
    return out


def keypoint_batch(cfg, seed):
    """``train_batch`` with ``num_keypoints`` keypoints in each box: a fifth
    unlabeled (v = 0, coordinates zero), a fifth hidden (v = 1)."""
    batch = train_batch(cfg, seed=seed)
    rng = np.random.default_rng(seed + 200)
    b, g = batch["gt_valid"].shape
    k = cfg.data.num_keypoints
    boxes = batch["gt_boxes"]
    frac = rng.uniform(0.05, 0.95, (b, g, k, 2))
    xy = boxes[:, :, None, :2] + frac * (boxes[:, :, None, 2:]
                                         - boxes[:, :, None, :2])
    vis = rng.choice([0.0, 1.0, 2.0], (b, g, k), p=[0.2, 0.2, 0.6])
    kps = np.concatenate([xy * (vis > 0)[..., None], vis[..., None]], -1)
    batch["gt_keypoints"] = (kps * batch["gt_valid"][:, :, None, None]
                             ).astype(np.float32)
    return batch


# ------------------------------------------------------------------ head
@pytest.mark.parametrize("size", [7, 14])
def test_keypoint_head_equals_flax(size):
    rng = np.random.default_rng(size)
    x = rng.normal(0, 1, (6, size, size, 16)).astype(np.float32)
    jhead = JaxKeypointHead(num_keypoints=5, num_convs=2, channels=12)
    v = jax.tree_util.tree_map(
        np.asarray, jhead.init(jax.random.key(1), jnp.asarray(x)))
    ref = np.asarray(jhead.apply(v, jnp.asarray(x)))
    head = KeypointHead(16, 5, num_convs=2, channels=12)
    sd = from_flax_variables(v)
    head.load_state_dict(sd)
    out = head(t(x))
    assert out.dtype == torch.float32 and out.shape == (6, 4 * size,
                                                        4 * size, 5)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5)
    # The converter's flip matters for the overlapping 4x4 kernel too.
    kernel = np.asarray(v["params"]["deconv"]["kernel"])
    sd["deconv.weight"] = torch.from_numpy(
        np.ascontiguousarray(kernel.transpose(2, 3, 0, 1)))
    head.load_state_dict(sd)
    assert np.abs(head(t(x)).detach().numpy() - ref).max() > 1e-3


def test_keypoint_head_init_draws_flax_distributions():
    from tpudet_torch.models.layers import init_module

    head = KeypointHead(256, 17, num_convs=2, channels=512)
    init_module(head, torch.Generator().manual_seed(0))
    for name, std in (("conv1", (2 / (9 * 512)) ** 0.5),
                      ("deconv", (2 / (16 * 17)) ** 0.5)):
        w = getattr(head, name).weight
        assert float(w.std()) == pytest.approx(std, rel=0.03), name
        assert float(getattr(head, name).bias.abs().max()) == 0.0


def test_constructor_checks_as_jax():
    jcfg, tcfg = keypoint_configs("c4")
    assert isinstance(build_model(tcfg, device="cpu"), KeypointRCNN)
    for mod_cfg in ((jcfg.replace(rpn_only=True), tcfg.replace(rpn_only=True)),
                    (jcfg.replace(det_only=True), tcfg.replace(det_only=True)),
                    tuple(c.replace(data=dataclasses.replace(
                        c.data, keypoint_flip_pairs=((1, 9),)))
                        for c in (jcfg, tcfg))):
        with pytest.raises(ValueError) as ref:
            JaxKeypointRCNN(mod_cfg[0])
        with pytest.raises(ValueError) as port:
            build_model(mod_cfg[1], device="cpu")
        assert str(port.value).split(" (")[0] == str(ref.value).split(" (")[0]


# ------------------------------------------------------------------ targets
def targets_both(rois, gt_kps, matched):
    """The port's targets and tpudet's, eager and under jax.jit (as its loss
    runs them), for one batch."""
    jm = JaxKeypointRCNN(jconfig.tiny_keypoint_config())
    tm = build_model(tconfig.tiny_keypoint_config(), device="cpu")
    fn = jax.vmap(jm._keypoint_targets_single)
    eager = [np.asarray(x) for x in fn(rois, gt_kps, matched)]
    jitted = [np.asarray(x) for x in jax.jit(fn)(rois, gt_kps, matched)]
    port = [x.numpy() for x in tm._keypoint_targets_single(
        t(rois), t(gt_kps), t(matched))]
    return port, eager, jitted


def test_keypoint_targets_hand_scene():
    """tpudet's hand scene (tests/test_keypoint.py): S = 28, a cell
    inside, the last cell, outside the RoI, unlabeled, hidden at the
    corner."""
    rois = np.array([[[0.0, 0.0, 56.0, 56.0]]], np.float32)
    gt = np.zeros((1, 10, 5, 3), np.float32)
    gt[0, 0] = [[2.0, 4.0, 2.0], [55.9, 55.9, 2.0], [60.0, 10.0, 2.0],
                [10.0, 10.0, 0.0], [0.0, 0.0, 1.0]]
    port, eager, jitted = targets_both(rois, gt, np.zeros((1, 1), np.int32))
    for ref in (eager, jitted):
        np.testing.assert_array_equal(port[0], ref[0])
        np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_array_equal(port[1][0, 0],
                                  [True, True, False, False, True])
    assert port[0][0, 0, 0] == 2 * 28 + 1 and port[0][0, 0, 1] == 28 * 28 - 1
    assert port[0][0, 0, 4] == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_keypoint_targets_on_cell_edges_equal_jax(seed):
    """Random RoIs, keypoints put on their cell edges (``x1 + j * w / S``
    in f32, either side of an edge by rounding), at the RoI's borders and
    beyond, unlabeled and hidden: indices and validity exactly equal to
    tpudet's eager and jitted targets."""
    rng = np.random.default_rng(seed)
    b, r, g, k, s = 2, 48, 10, 5, 28
    xy = rng.uniform(0, 100, (b, r, 2))
    wh = rng.uniform(4, 90, (b, r, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    rois[:, ::7, 2:] = rois[:, ::7, :2] + np.float32(56.0)  # round widths
    matched = rng.integers(0, g, (b, r)).astype(np.int32)
    gt = np.zeros((b, g, k, 3), np.float32)
    for i in range(b):
        for j in range(g):
            m = np.flatnonzero(matched[i] == j)
            box = rois[i, m[0]] if len(m) else rois[i, 0]
            w, h = box[2] - box[0], box[3] - box[1]
            cell = rng.integers(-1, s + 2, (k, 2)).astype(np.float32)
            gt[i, j, :, 0] = box[0] + cell[:, 0] * w / np.float32(s)
            gt[i, j, :, 1] = box[1] + cell[:, 1] * h / np.float32(s)
            gt[i, j, :, 2] = rng.choice([0.0, 1.0, 2.0], k)
    port, eager, jitted = targets_both(rois, gt, matched)
    np.testing.assert_array_equal(port[1], eager[1])
    np.testing.assert_array_equal(port[0], eager[0])
    np.testing.assert_array_equal(port[1], jitted[1])
    np.testing.assert_array_equal(port[0], jitted[0])
    assert 0.1 < port[1].mean() < 0.8


# ------------------------------------------------------------------ loss
def test_keypoint_loss_equals_jax_and_closed_form():
    rng = np.random.default_rng(4)
    b, r, s, k = 2, 6, 8, 3
    logits = rng.normal(0, 2, (b, r, s, s, k)).astype(np.float32)
    idx = rng.integers(0, s * s, (b, r, k)).astype(np.int32)
    valid = rng.uniform(size=(b, r, k)) < 0.6
    fg = rng.uniform(size=(b, r)) < 0.7
    ref = np.asarray(jax.vmap(jlosses.keypoint_loss)(logits, idx, valid, fg))
    port = tlosses.keypoint_loss(t(logits), t(idx), t(valid), t(fg)).numpy()
    np.testing.assert_allclose(port, ref, rtol=1e-6)
    # tpudet's closed forms: uniform logits give ln(S^2); no valid
    # keypoint gives exactly 0.
    uniform = torch.zeros(b, r, s, s, k)
    np.testing.assert_allclose(
        tlosses.keypoint_loss(uniform, t(idx), t(valid), t(fg)).numpy(),
        math.log(s * s), rtol=1e-6)
    zero = tlosses.keypoint_loss(uniform, t(idx), torch.zeros(b, r, k, dtype=torch.bool),
                                 t(fg))
    assert (zero == 0).all() and torch.isfinite(zero).all()


# ------------------------------------------------------------------ model
def keypoint_pair(jcfg, tcfg, seed):
    jm = JaxKeypointRCNN(jcfg)
    v = random_variables(jm, seed)
    tm = build_model(tcfg, device="cpu")
    tm.core.load_state_dict(from_flax_variables(v))  # strict
    return jm, v, tm


@pytest.fixture(scope="module", params=["c4", "fpn"])
def run(request):
    """One loss and gradient and one predict of each package."""
    jcfg, tcfg = keypoint_configs(request.param)
    jm, v, tm = keypoint_pair(jcfg, tcfg, seed=31)
    batch = keypoint_batch(tcfg, seed=6)
    rng = jax.random.key(17)

    def loss(params):
        return jm.loss({**v, "params": params}, batch, rng)

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    shapes = tm.draw_shapes(2, batch["image"].shape[1:3])
    draws = jax_draws(rng, 2, shapes["rpn"][1], shapes["roi"][1])
    total, port_metrics = tm.loss({k: t(x) for k, x in batch.items()},
                                  draws=draws)
    total.backward()

    prng = np.random.default_rng(18)
    pbatch = {"image": prng.integers(0, 256, (2, 128, 128, 3),
                                     dtype=np.uint8),
              "image_hw": np.array([[128, 128], [104, 120]], np.float32)}
    ref = jax.jit(lambda v, bt: jm.predict(v, jpre.device_preprocess(
        jcfg, bt)))(v, pbatch)
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
    if run["variant"] == "c4":
        # keypoint_tiny's bar (tests/test_keypoint.py): near ln(S^2) at
        # init, the term added to the total once.
        s = 4 * run["tcfg"].keypoint.roi_output_size
        assert 0.5 * math.log(s * s) < ref["keypoint_loss"] \
            < 1.5 * math.log(s * s)


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
    for name in ("conv1", "deconv"):
        assert getattr(tm.core.keypoint_head, name).weight.grad.abs().max() > 0


def test_predict_keypoints_equal_jax(run):
    ref, out = run["predict"]
    assert set(out) == set(ref)
    k = run["tcfg"].data.num_keypoints
    assert out["keypoints"].shape == (2, 20, k, 3)
    assert (ref["num_detections"] > 3).all()
    assert_same_detections(out, ref)
    compared = 0
    for b in range(2):
        n = int(ref["num_detections"][b])
        for i in range(n):
            j = next(j for j in range(n)
                     if out["classes"][b, j] == ref["classes"][b, i]
                     and abs(out["scores"][b, j] - ref["scores"][b, i]) < 1e-4
                     and np.allclose(out["boxes"][b, j], ref["boxes"][b, i],
                                     rtol=1e-4, atol=1e-3))
            np.testing.assert_allclose(out["keypoints"][b, j, :, :2],
                                       ref["keypoints"][b, i, :, :2],
                                       atol=1e-3, rtol=1e-4)
            np.testing.assert_allclose(out["keypoints"][b, j, :, 2],
                                       ref["keypoints"][b, i, :, 2],
                                       atol=1e-5)
            compared += 1
        assert (out["keypoints"][b][~out["valid"][b]] == 0).all()
    assert compared > 6


def test_loss_without_gt_keypoints_raises(run):
    batch = {k: t(x) for k, x in run["batch"].items() if k != "gt_keypoints"}
    with pytest.raises(KeyError, match="gt_keypoints"):
        run["tm"].loss(batch, draws=run["draws"])


def test_tied_heatmap_takes_the_first_maximum():
    """A heatmap whose maximum is tied over several cells decodes to the
    first (row-major) of them, as jnp.argmax: the keypoint at that cell's
    centre."""
    tcfg = tconfig.tiny_keypoint_config()
    tm = build_model(tcfg, device="cpu")
    s, k = 28, tcfg.data.num_keypoints
    logits = torch.zeros(1, s, s, k)
    for kk, cells in enumerate(((3, 5), (0, 0), (27, 27), (10, 2), (4, 4))):
        logits[0, cells[0], cells[1], kk] = 5.0
        logits[0, 20, 20, kk] = 5.0  # the tie, later in row-major order
    tm.core.keypoints = lambda pooled: logits.expand(pooled.shape[0], -1,
                                                     -1, -1)
    out = {"boxes": torch.tensor([[[0.0, 0.0, 56.0, 28.0]]]),
           "valid": torch.tensor([[True]])}
    feats = {"c4": torch.zeros(1, tm.core.backbone.channels["c4"], 8, 8)}
    kps = tm._predict_extras(feats, out, {})["keypoints"][0, 0]
    ref_idx = np.argmax(np.asarray(jnp.asarray(logits.numpy()).reshape(
        s * s, k)), axis=0)
    for kk, (row, col) in enumerate(((3, 5), (0, 0), (20, 20), (10, 2),
                                     (4, 4))):
        assert ref_idx[kk] == row * s + col
        assert float(kps[kk, 0]) == pytest.approx((col + 0.5) / s * 56.0)
        assert float(kps[kk, 1]) == pytest.approx((row + 0.5) / s * 28.0)


# ------------------------------------------------------------------ data
def test_prepare_example_keypoints_equal_jax():
    jcfg, tcfg = jconfig.tiny_keypoint_config(), tconfig.tiny_keypoint_config()
    rng = np.random.default_rng(8)
    image = rng.integers(0, 256, (150, 200, 3), dtype=np.uint8)
    boxes = np.array([[10, 20, 80, 90], [100, 30, 190, 140],
                      [5, 5, 40, 40]], np.float32)
    kps = [np.concatenate([rng.uniform(0, 150, (5, 2)),
                           rng.choice([0.0, 1.0, 2.0], (5, 1))], 1),
           None,  # an instance without keypoints
           np.concatenate([rng.uniform(0, 150, (5, 2)),
                           np.full((5, 1), 2.0)], 1)]
    classes = np.array([1, 2, 3], np.int32)
    ref = jpre.prepare_example(jcfg.data, image, boxes, classes, None,
                               keypoints=kps)
    port = tpre.prepare_example(tcfg.data, image, boxes, classes,
                                keypoints=kps)
    assert port["gt_keypoints"].shape == (10, 5, 3)
    np.testing.assert_array_equal(port["gt_keypoints"], ref["gt_keypoints"])
    assert (port["gt_keypoints"][1] == 0).all()
    # Back to original pixels, as the eval CLI rescales them.
    np.testing.assert_array_equal(
        tpre.rescale_keypoints_to_original(port["gt_keypoints"],
                                           port["image_scale"],
                                           port["orig_hw"]),
        jpre.rescale_keypoints_to_original(ref["gt_keypoints"],
                                           ref["image_scale"],
                                           ref["orig_hw"]))
    with pytest.raises(ValueError, match="num_keypoints"):
        tpre.prepare_example(tcfg.data, image, boxes, classes,
                             keypoints=[np.zeros((4, 3))] * 3)


def test_train_flip_with_pair_swap_equals_jax_given_its_draw():
    jcfg, tcfg = jconfig.tiny_keypoint_config(), tconfig.tiny_keypoint_config()
    rng = np.random.default_rng(5)
    b = 4
    batch = keypoint_batch(tcfg, seed=3)
    raw = {"image": rng.integers(0, 256, (b, 128, 128, 3), dtype=np.uint8),
           "image_hw": np.array([[128, 128], [100, 90], [128, 64],
                                 [77, 128]], np.float32),
           "gt_boxes": np.concatenate([batch["gt_boxes"]] * 2),
           "gt_keypoints": np.concatenate([batch["gt_keypoints"]] * 2)}
    flipped = 0
    for seed in range(3):
        key = jax.random.key(seed)
        ref = jpre.device_preprocess(
            jcfg, {k: jnp.asarray(v) for k, v in raw.items()}, rng=key,
            training=True)
        draws = augment_draws(key, b, jitter_on=False)
        port = tpre.device_preprocess(tcfg, {k: t(v) for k, v in raw.items()},
                                      training=True, draws=draws)
        np.testing.assert_array_equal(port["gt_keypoints"].numpy(),
                                      np.asarray(ref["gt_keypoints"]))
        flip = draws["flip"].numpy()
        for i in np.flatnonzero(flip):  # pair (1, 2) swapped, x mirrored
            gk, ok = raw["gt_keypoints"][i], port["gt_keypoints"][i].numpy()
            lab = gk[:, 2, 2] > 0
            np.testing.assert_array_equal(
                ok[lab, 1, 0], raw["image_hw"][i, 1] - gk[lab, 2, 0])
        flipped += int(flip.sum())
    assert 0 < flipped < 12


def test_loader_emits_keypoints_as_jax():
    from tpudet.data.loader import DataLoader as JaxLoader
    from tpudet.data.synthetic import SyntheticDataset as JaxSynthetic
    from tpudet_torch.data import DataLoader, SyntheticDataset, build_dataset

    jcfg, tcfg = jconfig.tiny_keypoint_config(), tconfig.tiny_keypoint_config()
    port = DataLoader(tcfg, build_dataset(tcfg, "val"), 2, shuffle=False,
                      num_workers=2)
    ref = JaxLoader(jcfg, JaxSynthetic(3, num_examples=64, image_size=256,
                                       seed=1, with_keypoints=True),
                    2, shuffle=False, num_workers=2, process_index=0,
                    process_count=1)
    for _, p, r in zip(range(2), port.batches(0), ref.batches(0)):
        assert set(p) == set(r) and "gt_keypoints" in p
        for k in r:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    assert isinstance(build_dataset(tcfg, "val"), SyntheticDataset)

