"""Panoptic FPN of the PyTorch port against ``tpudet``'s, on the CPU: the
semantic head against Flax's (f32 on a canvas that 32 does not divide, and
bf16), ``semantic_loss`` and its all-void case, the host-side fusion and
PQ (``fuse_panoptic``, ``gt_panoptic``, ``PanopticEvaluator``) on tpudet's
hand scenes and random ones, ``CocoPanopticDataset`` on a small JSON and
PNG set, ``prepare_example``'s ``gt_semantic`` (an image narrower than its
canvas) and its train-time flip given JAX's draw, the loader, and
``loss``, its gradients and ``predict`` on ``panoptic_tiny`` given JAX's
sampler draws.

Weights: Flax's init with ``test_torch_faster_rcnn.random_variables``'s
widened heads, the mask predictor drawn at std 0.3 (as
``tests/test_torch_mask_rcnn.py``) and the semantic predictor at std 0.3
(at Flax's normal(0.01) every class would tie near 1/C and the argmax
would hide a fault). Batches: ``tests/test_torch_mask_rcnn.py``'s
``mask_batch`` with a quarter-scale semantic map of random stuff and the
boxes' thing classes painted on, void outside the image.

Tolerances: the head within ``1e-5`` in f32; in bf16 within ``2^-5`` of its
largest value, the rule of ``tests/test_torch_bf16_parity.py`` (the
tower's bf16 convolutions round in other orders; the 2x upsamples compute
in f32 in both packages and round to bf16); the fusion's maps and
segments, the PQ summaries and the dataset's arrays exactly equal; the
semantic loss within ``1e-6`` relative; every loss term within ``1e-5``
relative; gradients as ``tests/test_torch_mask_rcnn.py``'s FPN variant
(``5e-4`` of each's largest magnitude: the mask head's ReLU there);
detections as ``assert_same_detections``, each matched detection's mask
within ``1e-5``, and the semantic maps equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_data_preprocess import jax_draws as augment_draws
from tests.test_torch_faster_rcnn import (
    assert_same_detections,
    random_variables,
)
from tests.test_torch_faster_rcnn_train import jax_draws, t
from tests.test_torch_mask_rcnn import jitted_targets, mask_batch
from tpudet import config as jconfig
from tpudet.data import preprocess as jpre
from tpudet.eval import panoptic as jpan
from tpudet.models import PanopticFPN as JaxPanopticFPN
from tpudet.models.semantic_head import SemanticHead as JaxSemanticHead
from tpudet.train import losses as jlosses
from tpudet_torch import config as tconfig
from tpudet_torch.data import preprocess as tpre
from tpudet_torch.eval import panoptic as tpan
from tpudet_torch.models import build_model
from tpudet_torch.models import mask_rcnn as tmask_rcnn
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.models.panoptic_fpn import PanopticFPN
from tpudet_torch.models.semantic_head import SemanticHead
from tpudet_torch.train import losses as tlosses
from tpudet_torch.train.step import make_eval_step

torch.set_num_threads(2)
METRICS = ("loss", "rpn_cls_loss", "rpn_box_loss", "det_cls_loss",
           "det_box_loss", "num_pos_anchors", "num_fg_rois", "mask_loss",
           "semantic_loss")
PREDICT_STD = 0.3


def pyramid(rng, b, h, w, c):
    """p2..p5 maps (NHWC) of a canvas ``h`` x ``w``: ceil(side / stride)
    cells per side, as the FPN's SAME stride-2 convolutions give."""
    return {f"p{l}": rng.normal(0, 1, (b, -(-h // s), -(-w // s), c)
                                ).astype(np.float32)
            for l, s in ((2, 4), (3, 8), (4, 16), (5, 32))}


# ------------------------------------------------------------------ head
@pytest.mark.parametrize("dtype,canvas", [("float32", (100, 136)),
                                          ("float32", (128, 128)),
                                          ("bfloat16", (100, 136))])
def test_semantic_head_equals_flax(dtype, canvas):
    rng = np.random.default_rng(canvas[0])
    feats = pyramid(rng, 2, *canvas, 16)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jhead = JaxSemanticHead(num_classes=6, channels=32, dtype=jdt)
    v = jax.tree_util.tree_map(np.array, jax.jit(jhead.init)(
        jax.random.key(2), {k: jnp.asarray(x) for k, x in feats.items()}))
    flat = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    for path, leaf in flat:  # GroupNorm affine away from its identity
        if path[0].key.startswith(("p2_gn", "p5_gn")):
            leaf[...] = rng.uniform(0.5, 1.5, leaf.shape) \
                if path[-1].key == "scale" else rng.normal(0, 0.2, leaf.shape)
    v["params"]["predict"]["kernel"] = rng.normal(
        0, PREDICT_STD, v["params"]["predict"]["kernel"].shape
    ).astype(np.float32)
    ref = np.asarray(jax.jit(jhead.apply)(v, {k: jnp.asarray(x)
                                              for k, x in feats.items()}))
    head = SemanticHead(16, 6, channels=32, dtype=getattr(torch, dtype))
    head.load_state_dict(from_flax_variables(v))  # strict: weight, bias
    out = head({k: t(x).permute(0, 3, 1, 2) for k, x in feats.items()})
    h4, w4 = -(-canvas[0] // 4), -(-canvas[1] // 4)
    assert out.dtype == torch.float32 and out.shape == (2, h4, w4, 6)
    tol = 1e-5 if dtype == "float32" else 2 ** -5 * np.abs(ref).max()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=tol)


def test_semantic_loss_equals_jax_and_closed_form():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (2, 8, 12, 5)).astype(np.float32)
    target = rng.integers(0, 6, (2, 8, 12)).astype(np.int32)
    ref = float(jlosses.semantic_loss(logits, target))
    assert float(tlosses.semantic_loss(t(logits), t(target))) == \
        pytest.approx(ref, rel=1e-6)
    # tpudet's closed forms: uniform logits ln(C) over the non-void pixels;
    # all void exactly 0.
    zeros = torch.zeros(2, 8, 12, 5)
    assert float(tlosses.semantic_loss(zeros, t(target))) == pytest.approx(
        np.log(5), rel=1e-6)
    void = tlosses.semantic_loss(zeros, torch.zeros(2, 8, 12,
                                                    dtype=torch.int32))
    assert float(void) == 0.0 and torch.isfinite(void)


# ------------------------------------------------------------------ fusion
def hand_scene():
    """tests/test_panoptic.py's scene: one thing (and its duplicate) over
    stuff class 1."""
    semantic = np.ones((16, 16), np.int32)
    semantic[4:8, 4:8] = 2
    boxes = np.asarray([[16.0, 16.0, 32.0, 32.0], [16.0, 16.0, 32.0, 32.0]])
    return (boxes, np.asarray([0.9, 0.8]), np.asarray([1, 1]),
            np.ones((2, 4, 4), np.float32), semantic)


def random_scene(rng, n=8, h4=24, w4=30, stuff=3, things=4):
    xy = rng.uniform(0, 80, (n, 2))
    wh = rng.uniform(8, 60, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1)
    scores = rng.uniform(0.3, 1.0, n)
    classes = rng.integers(1, things + 1, n)
    masks = rng.uniform(0, 1, (n, 14, 14)).astype(np.float32)
    semantic = rng.integers(0, stuff + things + 1, (h4, w4)).astype(np.int32)
    semantic[:, 26:] = 0  # padding
    return boxes, scores, classes, masks, semantic


def same_fusion(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]


@pytest.mark.parametrize("scene", ["hand", 0, 1, 2])
def test_fusion_and_pq_equal_jax(scene):
    if scene == "hand":
        boxes, scores, classes, masks, semantic = hand_scene()
        stuff, things, kw = 1, 1, dict(stuff_min_area=4)
    else:
        rng = np.random.default_rng(scene)
        boxes, scores, classes, masks, semantic = random_scene(rng)
        stuff, things, kw = 3, 4, dict(stuff_min_area=16,
                                       overlap_thresh=0.4)
    ref = jpan.fuse_panoptic(boxes, scores, classes, masks, semantic, stuff,
                             **kw)
    port = tpan.fuse_panoptic(boxes, scores, classes, masks, semantic, stuff,
                              **kw)
    same_fusion(port, ref)
    assert len(port[1]) >= 2
    gt_masks = (masks > 0.5).astype(np.uint8)
    gref = jpan.gt_panoptic(boxes[:-1], classes[:-1], gt_masks[:-1],
                            semantic, stuff)
    gport = tpan.gt_panoptic(boxes[:-1], classes[:-1], gt_masks[:-1],
                             semantic, stuff)
    same_fusion(gport, gref)
    evs = [mod.PanopticEvaluator(stuff, things) for mod in (jpan, tpan)]
    for ev, fused, gt in zip(evs, (ref, port), (gref, gport)):
        ev.add_image(*fused, *gt, pred_semantic=semantic,
                     gt_semantic=semantic)
        ev.add_image(*gt, *gt, pred_semantic=semantic, gt_semantic=semantic)
    assert evs[1].summarize() == evs[0].summarize()
    if scene == "hand":
        assert evs[1].summarize()["PQ"] == pytest.approx(1.0)


def test_coco_panoptic_dataset(tmp_path):
    """tests/test_panoptic.py's JSON and PNG set: ids R + 256 G + 65536 B,
    a thing, a stuff segment and a void strip, through both packages'
    readers and the port's ``build_dataset``."""
    from PIL import Image

    from tpudet.data.coco_panoptic import CocoPanopticDataset as JaxPanoptic
    from tpudet_torch.data import build_dataset
    from tpudet_torch.data.coco_panoptic import CocoPanopticDataset

    root = tmp_path
    (root / "annotations" / "panoptic_val2017").mkdir(parents=True)
    (root / "val2017").mkdir()
    Image.new("RGB", (32, 24)).save(root / "val2017" / "img1.jpg")
    ids = np.full((24, 32), 300, np.uint32)
    ids[4:12, 8:20] = 77
    ids[:, 30:] = 0
    png = np.stack([ids % 256, (ids // 256) % 256, ids // 65536],
                   axis=-1).astype(np.uint8)
    Image.fromarray(png).save(
        root / "annotations" / "panoptic_val2017" / "img1.png")
    blob = {
        "images": [{"id": 9, "file_name": "img1.jpg", "height": 24,
                    "width": 32}],
        "categories": [{"id": 1, "name": "person", "isthing": 1},
                       {"id": 200, "name": "sky", "isthing": 0}],
        "annotations": [{"image_id": 9, "file_name": "img1.png",
                         "segments_info": [
                             {"id": 77, "category_id": 1, "iscrowd": 0,
                              "bbox": [8, 4, 12, 8], "area": 96},
                             {"id": 300, "category_id": 200, "iscrowd": 0,
                              "bbox": [0, 0, 32, 24], "area": 672}]}],
    }
    with open(root / "annotations" / "panoptic_val2017.json", "w") as f:
        json.dump(blob, f)
    port = CocoPanopticDataset(str(root), split="val")
    ref = JaxPanoptic(str(root), split="val")
    assert port.num_classes == 1 and port.num_stuff_classes == 1
    ex, rex = port.get_example(0), ref.get_example(0)
    for k in ("image", "boxes", "classes", "crowd", "area", "semantic"):
        np.testing.assert_array_equal(ex[k], rex[k], err_msg=k)
    np.testing.assert_array_equal(ex["masks"][0], rex["masks"][0])
    assert ex["semantic"][0, 0] == 1 and ex["semantic"][8, 10] == 2
    assert (ex["semantic"][:, 30:] == 0).all()
    assert port.category_id(1) == 1 and port.image_id(0) == 9
    cfg = tconfig.Config(data=tconfig.DataConfig(
        dataset="coco", data_dir=str(root), num_classes=1, load_masks=True,
        load_semantic=True, num_stuff_classes=1))
    assert isinstance(build_dataset(cfg, "val"), CocoPanopticDataset)
    bad = cfg.replace(data=tconfig.DataConfig(
        dataset="coco", data_dir=str(root), num_classes=1, load_masks=True,
        load_semantic=True, num_stuff_classes=5))
    with pytest.raises(ValueError, match="stuff"):
        build_dataset(bad, "val")


# ------------------------------------------------------------------ data
def test_prepare_example_semantic_equals_jax():
    """An image narrower than its canvas and resized: each quarter-scale
    cell samples the original map, void outside the image."""
    jcfg, tcfg = jconfig.tiny_panoptic_config(), tconfig.tiny_panoptic_config()
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, (150, 90, 3), dtype=np.uint8)
    sem = rng.integers(0, 5, (150, 90)).astype(np.uint8)
    boxes = np.array([[10, 20, 60, 90]], np.float32)
    classes = np.array([2], np.int32)
    ref = jpre.prepare_example(jcfg.data, image, boxes, classes, None,
                               semantic=sem)
    port = tpre.prepare_example(tcfg.data, image, boxes, classes,
                                semantic=sem)
    assert port["gt_semantic"].shape == (32, 32)
    np.testing.assert_array_equal(port["gt_semantic"], ref["gt_semantic"])
    assert (port["gt_semantic"][:, 20:] == 0).all()  # 77 px wide of 128
    # No map: all void.
    none = tpre.prepare_example(tcfg.data, image, boxes, classes)
    assert none["gt_semantic"].dtype == np.int32
    assert (none["gt_semantic"] == 0).all()


def test_train_flip_of_gt_semantic_equals_jax_given_its_draw():
    jcfg, tcfg = jconfig.tiny_panoptic_config(), tconfig.tiny_panoptic_config()
    rng = np.random.default_rng(6)
    b = 4
    hw = np.array([[128, 128], [100, 90], [128, 61], [77, 128]], np.float32)
    raw = {"image": rng.integers(0, 256, (b, 128, 128, 3), dtype=np.uint8),
           "image_hw": hw,
           "gt_boxes": rng.uniform(0, 60, (b, 10, 4)).astype(np.float32),
           "gt_semantic": rng.integers(0, 5, (b, 32, 32)).astype(np.int32)}
    flipped = 0
    for seed in range(3):
        key = jax.random.key(seed)
        ref = jpre.device_preprocess(
            jcfg, {k: jnp.asarray(v) for k, v in raw.items()}, rng=key,
            training=True)
        draws = augment_draws(key, b, jitter_on=False)
        port = tpre.device_preprocess(tcfg, {k: t(v) for k, v in raw.items()},
                                      training=True, draws=draws)
        np.testing.assert_array_equal(port["gt_semantic"].numpy(),
                                      np.asarray(ref["gt_semantic"]))
        for i in np.flatnonzero(draws["flip"].numpy()):
            w4 = int(np.ceil((hw[i, 1] - 1.5) / 4.0))
            np.testing.assert_array_equal(
                port["gt_semantic"][i, :, :w4].numpy(),
                raw["gt_semantic"][i, :, :w4][:, ::-1])
            flipped += 1
    assert 0 < flipped < 12


def test_loader_emits_semantic_maps_as_jax():
    from tpudet.data.loader import DataLoader as JaxLoader
    from tpudet.data.synthetic import SyntheticDataset as JaxSynthetic
    from tpudet_torch.data import DataLoader, build_dataset

    jcfg, tcfg = jconfig.tiny_panoptic_config(), tconfig.tiny_panoptic_config()
    port = DataLoader(tcfg, build_dataset(tcfg, "val"), 2, shuffle=False,
                      num_workers=2)
    ref = JaxLoader(jcfg, JaxSynthetic(3, num_examples=64, image_size=256,
                                       seed=1, with_masks=True,
                                       with_semantic=True),
                    2, shuffle=False, num_workers=2, process_index=0,
                    process_count=1)
    for _, p, r in zip(range(2), port.batches(0), ref.batches(0)):
        assert set(p) == set(r) and {"gt_semantic", "gt_masks"} <= set(p)
        for k in r:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)


# ------------------------------------------------------------------ model
def test_constructor_refusals_as_jax():
    jcfg, tcfg = jconfig.tiny_panoptic_config(), tconfig.tiny_panoptic_config()
    assert isinstance(build_model(tcfg, device="cpu"), PanopticFPN)
    for case in ("no_fpn", "no_semantic"):
        pair = []
        for cfg in (jcfg, tcfg):
            if case == "no_fpn":
                cfg = cfg.replace(backbone=cfg.backbone.__class__(
                    **{**cfg.backbone.__dict__, "use_fpn": False}))
            else:
                cfg = cfg.replace(data=cfg.data.__class__(
                    **{**cfg.data.__dict__, "load_semantic": False}))
            pair.append(cfg)
        with pytest.raises(ValueError) as ref:
            JaxPanopticFPN(pair[0])
        with pytest.raises(ValueError) as port:
            build_model(pair[1], device="cpu")
        assert str(port.value) == str(ref.value)


def panoptic_batch(cfg, seed):
    """``mask_batch`` with a quarter-scale map: random stuff classes
    1..S over the image, each box's thing class S + c painted over its
    cells, void (0) outside the image."""
    batch = mask_batch(cfg, seed)
    rng = np.random.default_rng(seed + 300)
    s = cfg.data.num_stuff_classes
    h4 = -(-cfg.data.canvas_height // 4)
    sem = rng.integers(1, s + 1, (2, h4, h4)).astype(np.int32)
    for i in range(2):
        for box, c, ok in zip(batch["gt_boxes"][i] / 4,
                              batch["gt_classes"][i], batch["gt_valid"][i]):
            if ok:
                x1, y1, x2, y2 = box.astype(int)
                sem[i, y1:y2 + 1, x1:x2 + 1] = s + c
        hh, ww = np.ceil((batch["image_hw"][i] - 1.5) / 4).astype(int)
        sem[i, hh:], sem[i, :, ww:] = 0, 0
    batch["gt_semantic"] = sem
    return batch


@pytest.fixture(scope="module")
def run():
    """One loss and gradient and one predict of each package on
    panoptic_tiny."""
    jcfg, tcfg = jconfig.tiny_panoptic_config(), tconfig.tiny_panoptic_config()
    jm = JaxPanopticFPN(jcfg)
    v = random_variables(jm, 41)
    rng = np.random.default_rng(42)
    for head in ("mask_head", "semantic_head"):
        p = v["params"][head]["predict"]
        p["kernel"] = rng.normal(0, PREDICT_STD, p["kernel"].shape
                                 ).astype(np.float32)
    tm = build_model(tcfg, device="cpu")
    tm.core.load_state_dict(from_flax_variables(v))  # strict
    batch = panoptic_batch(tcfg, seed=7)
    key = jax.random.key(19)

    def loss(params):
        return jm.loss({**v, "params": params}, batch, key)

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    shapes = tm.draw_shapes(2, batch["image"].shape[1:3])
    draws = jax_draws(key, 2, shapes["rpn"][1], shapes["roi"][1])
    ties = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmask_rcnn, "mask_targets", jitted_targets(ties))
        total, port_metrics = tm.loss({k: t(x) for k, x in batch.items()},
                                      draws=draws)
    total.backward()
    prng = np.random.default_rng(20)
    pbatch = {"image": prng.integers(0, 256, (2, 128, 128, 3),
                                     dtype=np.uint8),
              "image_hw": np.array([[128, 128], [100, 116]], np.float32)}
    ref = jax.jit(lambda v, bt: jm.predict(v, jpre.device_preprocess(
        jcfg, bt)))(v, pbatch)
    out = make_eval_step(tm, tcfg)(pbatch)
    return dict(
        tm=tm, tcfg=tcfg, batch=batch, draws=draws,
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
    assert ref["semantic_loss"] > 0.1 and ref["mask_loss"] > 0.1


def test_gradients_equal_jax(run):
    tm, ref_grads = run["tm"], run["grads"]
    assert set(n for n, _ in tm.core.named_parameters()) == set(ref_grads)
    floor = 1e-6 * max(float(g.abs().max()) for g in ref_grads.values())
    for name, p in tm.core.named_parameters():
        want = ref_grads[name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=5e-4 * np.abs(want).max() + floor,
                                   err_msg=name)
    head = tm.core.semantic_head
    for name in ("p2_conv0", "p5_conv2", "p4_gn1", "predict"):
        assert getattr(head, name).weight.grad.abs().max() > 0


def test_predict_equals_jax(run):
    ref, out = run["predict"]
    assert set(out) == set(ref) and "semantic" in out
    assert out["semantic"].shape == (2, 32, 32)
    assert out["semantic"].dtype == np.int32
    np.testing.assert_array_equal(out["semantic"], ref["semantic"])
    c = run["tcfg"].data.num_stuff_classes + run["tcfg"].data.num_classes
    assert out["semantic"].min() >= 1 and out["semantic"].max() <= c
    assert len(np.unique(out["semantic"])) > 1
    assert (ref["num_detections"] > 3).all()
    assert_same_detections(out, ref)
    for b in range(2):
        n = int(ref["num_detections"][b])
        for i in range(n):
            k = next(k for k in range(n)
                     if out["classes"][b, k] == ref["classes"][b, i]
                     and abs(out["scores"][b, k] - ref["scores"][b, i]) < 1e-4
                     and np.allclose(out["boxes"][b, k], ref["boxes"][b, i],
                                     rtol=1e-4, atol=1e-3))
            np.testing.assert_allclose(out["masks"][b, k], ref["masks"][b, i],
                                       atol=1e-5)


def test_loss_without_gt_semantic_raises(run):
    batch = {k: t(x) for k, x in run["batch"].items() if k != "gt_semantic"}
    with pytest.raises(KeyError, match="gt_semantic"):
        run["tm"].loss(batch, draws=run["draws"])


def test_tied_semantic_logits_take_the_first_class():
    tm = build_model(tconfig.tiny_panoptic_config(), device="cpu")
    logits = torch.zeros(1, 4, 4, 4)
    logits[0, :, :, 1] = logits[0, :, :, 3] = 2.0  # channels 1 and 3 tie
    logits[0, 0, 0, 0] = 2.0  # three-way tie at one cell
    tm.core.semantic = lambda feats: logits
    with pytest.MonkeyPatch.context() as mp:  # the semantic branch alone
        mp.setattr(tmask_rcnn.MaskRCNN, "_predict_extras",
                   lambda self, feats, out, batch: out)
        sem = tm._predict_extras({}, {}, {})["semantic"]
    ref = np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1)) + 1
    np.testing.assert_array_equal(sem.numpy(), ref)
    assert sem[0, 0, 0] == 1 and (sem[0].flatten()[1:] == 2).all()

