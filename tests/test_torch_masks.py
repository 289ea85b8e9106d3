"""Mask R-CNN's data and target path of the PyTorch port against
``tpudet``'s, on the CPU, on the same numpy inputs from a seed: the
compressed-RLE codec, the box-frame crops (full masks, polygons, RLE), the
mask targets resampled over RoIs, the mask loss, ``prepare_example``'s
``gt_masks``, the loader's masks and the train-time flip of ``gt_masks``
given JAX's own draws.

Last, chip_smoke.py's mask_learning recipe on the CPU, held to the JAX
package's bars.

Tolerances: the RLE strings, the crops (PIL in both packages), the
loader's and ``prepare_example``'s ``gt_masks`` and the flipped crops are
equal; the resampled crops, the binary targets and the loss within
``1e-6`` (f32 products of at most two non-zero hat weights per row).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_data_preprocess import jax_draws
from tpudet import config as jconfig
from tpudet.data import masks as jmasks
from tpudet.data import preprocess as jpre
from tpudet.data.loader import DataLoader as JaxLoader
from tpudet.data.synthetic import SyntheticDataset as JaxSynthetic
from tpudet.ops import masks as jops
from tpudet.train import losses as jlosses
from tpudet_torch import config as tconfig
from tpudet_torch.data import DataLoader, SyntheticDataset, build_dataset
from tpudet_torch.data import masks as tmasks
from tpudet_torch.data import preprocess as tpre
from tpudet_torch.ops import masks as tops
from tpudet_torch.train import losses as tlosses

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.array(x))


def random_mask(rng, h, w, p=0.4):
    return (rng.random((h, w)) < p).astype(np.uint8)


def ellipse_polys(rng, box, k=2):
    """``k`` random polygons (5-9 points) inside ``box``, some points
    outside it."""
    x1, y1, x2, y2 = box
    out = []
    for _ in range(k):
        n = int(rng.integers(5, 10))
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(0.2, 0.7, n)
        cx, cy = rng.uniform(x1, x2), rng.uniform(y1, y2)
        xs = cx + r * np.cos(ang) * (x2 - x1)
        ys = cy + r * np.sin(ang) * (y2 - y1)
        out.append(np.stack([xs, ys], -1).reshape(-1).tolist())
    return out


# --------------------------------------------------------------------- RLE
def test_rle_strings_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        h, w = int(rng.integers(2, 60)), int(rng.integers(2, 60))
        m = random_mask(rng, h, w, rng.uniform(0.05, 0.95))
        m[0, 0] = rng.integers(0, 2)  # leading foreground runs too
        port, ref = tmasks.rle_encode(m), jmasks.rle_encode(m)
        assert port == ref
        np.testing.assert_array_equal(tmasks.rle_decode(port), m)
        counts = jmasks.rle_counts_from_string(ref["counts"])
        assert tmasks.rle_counts_from_string(port["counts"]) == counts
        assert tmasks.rle_string_from_counts(counts) == ref["counts"]
        np.testing.assert_array_equal(
            tmasks.rle_decode({"size": [h, w], "counts": counts}), m)
    with pytest.raises(ValueError, match="cover"):
        tmasks.rle_decode({"size": [3, 4], "counts": [2, 3]})


def test_mask_to_rle_equals_jax():
    rng = np.random.default_rng(1)
    for _ in range(10):
        probs = rng.random((28, 28)).astype(np.float32)
        hw = (int(rng.integers(40, 90)), int(rng.integers(40, 90)))
        x1, y1 = rng.uniform(-10, 50, 2)
        box = [x1, y1, x1 + rng.uniform(1, 60), y1 + rng.uniform(1, 60)]
        assert tmasks.mask_to_rle(probs, box, hw) == \
            jmasks.mask_to_rle(probs, box, hw)


# ------------------------------------------------------------------- crops
@pytest.mark.parametrize("m", [28, 112])
def test_crops_equal_jax(m):
    rng = np.random.default_rng(2)
    h, w = 90, 120
    boxes = np.array([[10.5, 5.25, 80.0, 60.75], [0.0, 0.0, 120.0, 90.0],
                      [40.0, 30.0, 41.5, 70.0], [60.0, 20.0, 60.0, 40.0],
                      [5.0, 50.0, 115.0, 88.0]], np.float32)
    full = random_mask(rng, h, w)
    polys = ellipse_polys(rng, boxes[0])
    rle = jmasks.rle_encode(random_mask(rng, h, w))
    raw_rle = {"size": [h, w],
               "counts": jmasks.rle_counts_from_string(rle["counts"])}
    reps = [full, polys, rle, None, raw_rle]
    for rep, box in zip(reps, boxes):
        np.testing.assert_array_equal(tmasks.crop_instance(rep, box, m),
                                      jmasks.crop_instance(rep, box, m))
    np.testing.assert_array_equal(
        tmasks.crop_from_polys(polys, boxes[4], m),
        jmasks.crop_from_polys(polys, boxes[4], m))
    port = tmasks.crop_instances(reps, boxes, m)
    np.testing.assert_array_equal(port, jmasks.crop_instances(reps, boxes, m))
    assert port.dtype == np.uint8 and port.shape == (5, m, m)
    assert port[0].any() and port[1].any() and not port[3].any()
    np.testing.assert_array_equal(tmasks.crop_instances(None, boxes, m),
                                  np.zeros((5, m, m), np.uint8))


def test_mask_iou_matrix_equals_jax():
    rng = np.random.default_rng(3)
    d_boxes = rng.uniform(0, 40, (4, 2))
    d_boxes = np.concatenate([d_boxes, d_boxes + rng.uniform(5, 30, (4, 2))],
                             -1)
    g_boxes = d_boxes[[1, 3, 0]] + rng.uniform(-3, 3, (3, 4))
    d_masks = [rng.random((28, 28)) for _ in range(4)]
    g_masks = [random_mask(rng, 56, 56, 0.6) for _ in range(3)]
    crowd = np.array([False, True, False])
    np.testing.assert_array_equal(
        tmasks.mask_iou_matrix(d_boxes, d_masks, g_boxes, g_masks, crowd),
        jmasks.mask_iou_matrix(d_boxes, d_masks, g_boxes, g_masks, crowd))


# ---------------------------------------------------------------- targets
def roi_scene(seed, b=2, g=5, r=12, m=28):
    """Box-frame crops and their boxes, and RoIs around them (some far
    away, some of zero size, one exactly a ground-truth box)."""
    rng = np.random.default_rng(seed)
    gt_boxes = rng.uniform(0, 80, (b, g, 2))
    gt_boxes = np.concatenate(
        [gt_boxes, gt_boxes + rng.uniform(4, 60, (b, g, 2))], -1
    ).astype(np.float32)
    gt_masks = (rng.random((b, g, m, m)) < 0.5).astype(np.uint8)
    matched = rng.integers(0, g, (b, r)).astype(np.int32)
    rois = gt_boxes[np.arange(b)[:, None], matched] + rng.normal(
        0, 8, (b, r, 4)).astype(np.float32)
    rois[:, 0] = gt_boxes[np.arange(b), matched[:, 0]]
    rois[:, 1] = [200.0, 200.0, 240.0, 260.0]
    rois[:, 2, 2:] = rois[:, 2, :2]
    return gt_masks, gt_boxes, rois.astype(np.float32), matched


@pytest.mark.parametrize("s", [14, 28])
def test_crop_mask_to_roi_and_mask_targets_equal_jax(s):
    gt_masks, gt_boxes, rois, matched = roi_scene(4)
    b = gt_masks.shape[0]
    rows = np.arange(b)[:, None]
    crops = gt_masks[rows, matched]
    boxes = gt_boxes[rows, matched]
    ref = jax.vmap(jax.vmap(functools.partial(jops.crop_mask_to_roi,
                                              out_size=s)))(
        jnp.asarray(crops, jnp.float32), jnp.asarray(boxes),
        jnp.asarray(rois))
    port = tops.crop_mask_to_roi(t(crops), t(boxes), t(rois), s)
    assert port.shape == (b, rois.shape[1], s, s)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6)
    # A RoI equal to its ground-truth box at the crop's size: the identity,
    # up to the rounding of the sample coordinates (f32, boxes of ~100 px).
    ident = tops.crop_mask_to_roi(t(crops[:, 0]), t(boxes[:, 0]),
                                  t(boxes[:, 0]), crops.shape[-1])
    np.testing.assert_allclose(ident.numpy(), crops[:, 0], atol=1e-4)
    assert float(port[:, 1].abs().max()) == 0.0  # far outside its box

    ref_t = jax.vmap(functools.partial(jops.mask_targets, out_size=s))(
        jnp.asarray(gt_masks), jnp.asarray(gt_boxes), jnp.asarray(rois),
        jnp.asarray(matched))
    port_t = tops.mask_targets(t(gt_masks), t(gt_boxes), t(rois), t(matched),
                               s)
    np.testing.assert_array_equal(port_t.numpy(), np.asarray(ref_t))
    assert set(np.unique(port_t.numpy())) == {0.0, 1.0}


@pytest.mark.parametrize("classes", [3, 1], ids=["per_class", "agnostic"])
def test_mask_loss_equals_jax(classes):
    rng = np.random.default_rng(5)
    b, r, m = 3, 16, 14
    logits = rng.normal(0, 3, (b, r, m, m, classes)).astype(np.float32)
    targets = (rng.random((b, r, m, m)) < 0.5).astype(np.float32)
    cls = rng.integers(0, 4, (b, r)).astype(np.int32)
    fg = (cls > 0) & (rng.random((b, r)) < 0.9)
    fg[2] = False  # an image without foreground: 0, not NaN
    ref = jax.vmap(jlosses.mask_loss)(*(jnp.asarray(x) for x in
                                        (logits, targets, cls, fg)))
    port = tlosses.mask_loss(t(logits), t(targets), t(cls), t(fg))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    assert float(port[2]) == 0.0 and float(port[0]) > 0.1


# ------------------------------------------------------------ data path
def mask_configs(m=28):
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.tiny_maskrcnn_config()
        out.append(cfg.replace(data=cfg.data.__class__(
            **{**cfg.data.__dict__, "gt_mask_size": m, "canvas_height": 160,
               "canvas_width": 160, "min_size": 120, "max_size": 160})))
    return out


@pytest.mark.parametrize("m", [28, 112])
def test_prepare_example_gt_masks_equal_jax(m):
    jcfg, tcfg = mask_configs(m)
    rng = np.random.default_rng(6)
    h, w = 100, 140
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    boxes = np.array([[10.0, 12.0, 60.0, 70.0], [50.0, 5.0, 130.0, 95.0],
                      [0.0, 0.0, 140.0, 100.0], [70.0, 40.0, 90.0, 44.0]],
                     np.float32)
    classes = np.array([1, 2, 3, 1], np.int32)
    masks = [random_mask(rng, h, w), ellipse_polys(rng, boxes[1]),
             jmasks.rle_encode(random_mask(rng, h, w)), None]
    port = tpre.prepare_example(tcfg.data, image, boxes, classes, masks=masks)
    ref = jpre.prepare_example(jcfg.data, image, boxes, classes, masks=masks)
    assert port["gt_masks"].shape == (jcfg.data.max_gt_boxes, m, m)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert port["gt_masks"][:3].any(axis=(1, 2)).all()
    assert not port["gt_masks"][3:].any()
    # Without load_masks no gt_masks, as in JAX.
    plain = tpre.prepare_example(tconfig.tiny_test_config().data, image,
                                 boxes, classes, masks=masks)
    assert "gt_masks" not in plain


def test_loader_and_synthetic_masks_equal_jax():
    jcfg, tcfg = jconfig.tiny_maskrcnn_config(), tconfig.tiny_maskrcnn_config()
    port = DataLoader(tcfg, SyntheticDataset(3, num_examples=4,
                                             image_size=128, with_masks=True),
                      2, shuffle=False, num_workers=2)
    ref = JaxLoader(jcfg, JaxSynthetic(3, num_examples=4, image_size=128,
                                       with_masks=True),
                    2, shuffle=False, num_workers=2, process_index=0,
                    process_count=1)
    for p, r in zip(port.batches(0), ref.batches(0)):
        assert set(p) == set(r)
        for k in r:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
        valid = p["gt_valid"]
        per = p["gt_masks"].reshape(2, valid.shape[1], -1).mean(-1)
        assert (per[valid] > 0.5).all() and (per[~valid] == 0).all()
    # build_dataset draws the ellipses where the config loads masks.
    ex = build_dataset(tcfg.replace(data=tcfg.data.__class__(
        **{**tcfg.data.__dict__, "dataset": "synthetic"}))).get_example(0)
    assert len(ex["masks"]) == len(ex["boxes"])


def test_train_flip_of_gt_masks_equals_jax_given_its_draws():
    jcfg, tcfg = jconfig.tiny_maskrcnn_config(), tconfig.tiny_maskrcnn_config()
    raw = next(iter(DataLoader(
        tcfg, SyntheticDataset(3, num_examples=4, image_size=128,
                               with_masks=True), 4, shuffle=False,
        num_workers=2).batches(0)))
    raw = {k: v for k, v in raw.items() if k != "example_index"}
    flipped = 0
    for seed in range(3):
        key = jax.random.key(seed)
        ref = jpre.device_preprocess(
            jcfg, {k: jnp.asarray(v) for k, v in raw.items()}, rng=key,
            training=True)
        draws = jax_draws(key, 4, jitter_on=False)
        port = tpre.device_preprocess(tcfg, {k: t(v) for k, v in raw.items()},
                                      training=True, draws=draws)
        np.testing.assert_array_equal(port["gt_masks"].numpy(),
                                      np.asarray(ref["gt_masks"]))
        np.testing.assert_allclose(port["gt_boxes"].numpy(),
                                   np.asarray(ref["gt_boxes"]), atol=1e-5)
        flip = draws["flip"].numpy()
        np.testing.assert_array_equal(port["gt_masks"][flip].numpy(),
                                      raw["gt_masks"][flip][..., ::-1])
        flipped += int(flip.sum())
    assert 0 < flipped < 12
    # The semantic maps that come with the masks (Panoptic FPN) flip with
    # the same draw, as JAX's.
    sem = np.random.default_rng(3).integers(0, 5, (4, 32, 32)).astype(np.int32)
    both = {**raw, "gt_semantic": sem}
    ref = jpre.device_preprocess(
        jcfg, {k: jnp.asarray(v) for k, v in both.items()}, rng=key,
        training=True)
    port = tpre.device_preprocess(tcfg, {k: t(v) for k, v in both.items()},
                                  training=True, draws=draws)
    np.testing.assert_array_equal(port["gt_semantic"].numpy(),
                                  np.asarray(ref["gt_semantic"]))


def test_mask_learning_check_on_the_cpu():
    """``chip_smoke.py``'s mask_learning phase (tests/test_maskrcnn.py's
    ``test_mask_loss_decreases``: maskrcnn_tiny, SGD 0.02, no warmup, 30
    steps on one synthetic batch) on the CPU's plain versions, with the
    JAX package's bars: the last loss under 0.8x the first, the last mask
    loss under 0.85x its first."""
    import chip_smoke

    losses, mask_losses = chip_smoke.mask_learning_losses("cpu")
    bars = chip_smoke.MASK_LEARNING
    assert len(losses) == bars["steps"] == 30
    print(f"mask learning on the CPU: loss {losses[-1] / losses[0]:.3f}x, "
          f"mask_loss {mask_losses[-1] / mask_losses[0]:.3f}x")
    assert losses[-1] < bars["loss"] * losses[0]
    assert mask_losses[-1] < bars["mask_loss"] * mask_losses[0]
