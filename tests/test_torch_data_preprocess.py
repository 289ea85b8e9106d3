"""The port's preprocessing (``tpudet_torch/data/preprocess.py``) against
the JAX package's (``tpudet/data/preprocess.py``), on the CPU:

* the host helpers (resize scale, scale jitter, buckets, canvases) equal
  over a grid of image sizes and jitter factors;
* the port's resize (PIL's bilinear resampling computed in torch) equal to
  PIL's bit for bit, on noise, over random sizes up and down;
* ``prepare_example``: every field equal, the image too;
* ``rescale_to_original`` equal;
* ``device_preprocess(training=True)`` given JAX's own draws (its key chain
  rebuilt here): normalized images within 1e-4, boxes equal, padding zero;
* the train step with ``fused_preprocess=True`` equal to
  ``device_preprocess`` with the step's augmentation draws followed by the
  step without it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet import config as jconfig
from tpudet.cli.common import preset_config as jax_preset
from tpudet.data import preprocess as jpre
from tpudet_torch import config as tconfig
from tpudet_torch.cli.common import preset_config
from tpudet_torch.data import preprocess as tpre

SIZES = [(1, 1), (37, 500), (128, 128), (256, 256), (333, 500), (375, 500),
         (500, 375), (480, 640), (600, 900), (1000, 200), (200, 1000),
         (427, 640), (640, 427), (2000, 3000)]
FACTORS = [0.5, 0.8, 0.93, 1.0, 1.2, 1.7]
JITTER = (0.125, 0.5, 0.5, 0.05)


def data_configs():
    """(name, port DataConfig, JAX DataConfig) with equal fields: the
    voc_r50 and coco_r101_fpn presets (aspect buckets), orientation buckets
    and one square canvas."""
    voc = preset_config("voc_r50").data
    out = [("voc_r50", voc, jax_preset("voc_r50").data),
           ("coco_r101_fpn", preset_config("coco_r101_fpn").data,
            jax_preset("coco_r101_fpn").data)]
    for name, kw in (("orientation", dict(aspect_buckets=(),
                                          orientation_buckets=True)),
                     ("square", dict(aspect_buckets=(), canvas_height=1024,
                                     canvas_width=1024))):
        port = dataclasses.replace(voc, **kw)
        out.append((name, port, jconfig.DataConfig(
            **{f.name: getattr(port, f.name)
               for f in dataclasses.fields(port)})))
    return out


CONFIGS = {name: (port, ref) for name, port, ref in data_configs()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_host_helpers_equal_jax(name):
    port, ref = CONFIGS[name]
    for h, w in SIZES:
        assert tpre.resize_scale(h, w, port.min_size, port.max_size) == \
            jpre.resize_scale(h, w, ref.min_size, ref.max_size)
        assert tpre.bucket_for_hw(port, h, w) == jpre.bucket_for_hw(ref, h, w)
        ch, cw = tpre.canvas_for_hw(port, h, w)
        assert (ch, cw) == jpre.canvas_for_hw(ref, h, w)
        for f in FACTORS:
            assert tpre.jittered_minmax(port, h, w, ch, cw, f) == \
                jpre.jittered_minmax(ref, h, w, ch, cw, f)


def random_example(rng, h, w, n):
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    xy = rng.uniform(0, 0.7, (n, 2)) * (w, h)
    wh = rng.uniform(0.05, 0.3, (n, 2)) * (w, h)
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return (image, boxes, rng.integers(1, 21, n).astype(np.int32),
            rng.uniform(0, 1, n) < 0.2, rng.uniform(0, 1, n) < 0.1,
            rng.uniform(10, 500, n).astype(np.float32))


def test_resize_equals_pil():
    from PIL import Image

    rng = np.random.default_rng(2)
    sizes = [((256, 256), (600, 600)), ((375, 500), (600, 800)),
             ((600, 1000), (480, 800)), ((333, 500), (250, 375)),
             ((1, 1), (5, 9)), ((7, 300), (1, 1000))]
    sizes += [(tuple(rng.integers(1, 700, 2)), tuple(rng.integers(1, 1100, 2)))
              for _ in range(40)]
    for (h, w), (nh, nw) in sizes:
        image = rng.integers(0, 256, (int(h), int(w), 3), dtype=np.uint8)
        ref = np.asarray(Image.fromarray(image).resize((int(nw), int(nh)),
                                                       Image.BILINEAR))
        np.testing.assert_array_equal(
            tpre.resize_uint8(image, int(nh), int(nw)), ref,
            err_msg=f"{(h, w)} -> {(nh, nw)}")


@pytest.mark.parametrize("name", ["voc_r50", "orientation"])
def test_prepare_example_equals_jax(name):
    port_cfg, ref_cfg = CONFIGS[name]
    rng = np.random.default_rng(3)
    for (h, w), factor, n in (((375, 500), 1.0, 3), ((500, 333), 1.0, 1),
                              ((256, 256), 0.8, 5), ((480, 640), 1.2, 2),
                              ((600, 1000), 1.0, 0), ((130, 800), 0.93, 4)):
        image, boxes, classes, difficult, crowd, area = random_example(
            rng, h, w, n)
        kw = dict(difficult=difficult, crowd=crowd, area=area,
                  scale_factor=factor)
        port = tpre.prepare_example(port_cfg, image, boxes, classes, **kw)
        ref = jpre.prepare_example(ref_cfg, image, boxes, classes, **kw)
        assert set(port) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
            assert port[k].dtype == ref[k].dtype, k


def test_prepare_example_truncates_like_jax():
    cfg = tconfig.tiny_test_config().data
    ref_cfg = jconfig.tiny_test_config().data
    rng = np.random.default_rng(4)
    image, boxes, classes, *_ = random_example(rng, 100, 150, 14)
    port = tpre.prepare_example(cfg, image, boxes, classes)
    ref = jpre.prepare_example(ref_cfg, image, boxes, classes)
    assert port["gt_valid"].sum() == cfg.max_gt_boxes
    for k in ("gt_boxes", "gt_classes", "gt_valid", "image_hw",
              "image_scale"):
        np.testing.assert_array_equal(port[k], ref[k])


def test_rescale_to_original_equals_jax():
    rng = np.random.default_rng(5)
    for _ in range(10):
        boxes = rng.uniform(-20, 700, (30, 4)).astype(np.float32)
        scale = rng.uniform(0.3, 3, 2).astype(np.float32)
        orig = rng.uniform(50, 900, 2).astype(np.float32)
        np.testing.assert_array_equal(
            tpre.rescale_to_original(boxes, scale, orig),
            jpre.rescale_to_original(boxes, scale, orig))


def jax_draws(key, b, jitter_on):
    """The draws JAX's ``device_preprocess(rng=key, training=True)`` makes,
    in the port's layout: the colour key split off first (when the jitter
    is on), one key per image split four ways, then one Bernoulli per image
    from what is left."""
    rng = key
    jitter = np.zeros((b, 4), np.float32)
    if jitter_on:
        rng, color_rng = jax.random.split(rng)
        for i, k in enumerate(jax.random.split(color_rng, b)):
            jitter[i] = [float(jax.random.uniform(kk, ()))
                         for kk in jax.random.split(k, 4)]
    flip = np.array(jax.random.bernoulli(rng, 0.5, (b,)))
    return {"jitter": torch.from_numpy(jitter), "flip": torch.from_numpy(flip)}


def aug_batch(rng, b, h, w):
    image = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    hw = np.stack([rng.integers(h // 2, h + 1, b),
                   rng.integers(w // 2, w + 1, b)], 1).astype(np.float32)
    hw[0] = (h, w)
    rows = np.arange(h)[None, :, None] < hw[:, 0, None, None]
    cols = np.arange(w)[None, None, :] < hw[:, 1, None, None]
    image = image * (rows & cols)[..., None]
    xy = rng.uniform(0, 0.6, (b, 5, 2)) * hw[:, None, ::-1]
    wh = rng.uniform(0.05, 0.4, (b, 5, 2)) * hw[:, None, ::-1]
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return {"image": image.astype(np.uint8), "image_hw": hw,
            "gt_boxes": boxes}


@pytest.mark.parametrize("jitter", [(0.0, 0.0, 0.0, 0.0), JITTER,
                                    (0.3, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 0.2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_preprocess_training_equals_jax_given_its_draws(jitter, dtype):
    port_cfg = tconfig.tiny_test_config()
    port_cfg = port_cfg.replace(
        data=dataclasses.replace(port_cfg.data, color_jitter=jitter),
        backbone=dataclasses.replace(port_cfg.backbone, dtype=dtype))
    ref_cfg = jconfig.tiny_test_config()
    ref_cfg = ref_cfg.replace(
        data=dataclasses.replace(ref_cfg.data, color_jitter=jitter),
        backbone=dataclasses.replace(ref_cfg.backbone, dtype=dtype))
    batch = aug_batch(np.random.default_rng(6), 6, 40, 56)
    key = jax.random.key(7)
    ref = jax.jit(lambda bt, k: jpre.device_preprocess(
        ref_cfg, bt, k, training=True))(
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
    draws = jax_draws(key, 6, any(x > 0 for x in jitter))
    assert 0 < int(draws["flip"].sum()) < 6  # both branches taken
    port = tpre.device_preprocess(
        port_cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
        training=True, draws=draws)
    got = port["image"].float().numpy()
    want = np.asarray(ref["image"].astype(jnp.float32))
    atol = 1e-4 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_array_equal(port["gt_boxes"].numpy(),
                                  np.asarray(ref["gt_boxes"]))
    # Padding stays zero: the normalized padding is exactly -mean / std.
    mean = torch.tensor(port_cfg.data.pixel_mean)
    std = torch.tensor(port_cfg.data.pixel_std)
    pad_value = ((torch.zeros(3) - mean) / std).to(port["image"].dtype)
    hw = batch["image_hw"]
    rows = np.arange(40)[None, :, None] >= hw[:, 0, None, None]
    cols = np.arange(56)[None, None, :] >= hw[:, 1, None, None]
    pad = torch.from_numpy(rows | cols)
    assert bool(pad.any())
    assert torch.equal(port["image"][pad],
                       pad_value.expand(int(pad.sum()), 3))


def test_device_preprocess_eval_is_plain_normalize():
    cfg = tconfig.tiny_test_config()
    batch = aug_batch(np.random.default_rng(8), 2, 32, 32)
    out = tpre.device_preprocess(
        cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    ref = jpre.device_preprocess(jconfig.tiny_test_config(),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["image"].numpy(), np.asarray(ref["image"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out["gt_boxes"].numpy(), batch["gt_boxes"])


def test_device_preprocess_training_needs_draws():
    cfg = tconfig.tiny_test_config()
    batch = {k: torch.from_numpy(v)
             for k, v in aug_batch(np.random.default_rng(9), 2, 16, 16).items()}
    with pytest.raises(ValueError, match="draws"):
        tpre.device_preprocess(cfg, batch, training=True)
    draws = tpre.augment_draws(torch.Generator().manual_seed(0), 2)
    assert draws["jitter"].shape == (2, 4) and draws["flip"].shape == (2,)


@pytest.mark.parametrize("accum", [1, 2])
def test_fused_step_equals_preprocess_then_step(accum):
    """Two SGD updates of the tiny model on loader batches (uint8 canvases)
    with the colour jitter on: the fused step equals
    ``device_preprocess(training=True)`` on the draws of its augmentation
    generator (``_augment_seed``, per microbatch) followed by the unfused
    step, loss and parameters alike."""
    from tpudet_torch.data import DataLoader
    from tpudet_torch.data.synthetic import SyntheticDataset
    from tpudet_torch.models import build_model
    from tpudet_torch.train import step as tstep
    from tpudet_torch.train.state import create_train_state

    cfg = tconfig.tiny_test_config()
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, color_jitter=JITTER),
        train=dataclasses.replace(cfg.train, batch_size=4, accum_steps=accum,
                                  warmup_steps=0, learning_rate=0.02))
    loader = DataLoader(cfg, SyntheticDataset(3, num_examples=16), 4,
                        num_workers=2)
    batches = list(loader.batches(0))[:2]

    def run(fused):
        model = build_model(cfg, device="cpu")
        state = create_train_state(model, cfg.train, seed=0, device="cpu")
        step = tstep.make_train_step(model, cfg, device="cpu",
                                     fused_preprocess=fused)
        losses = []
        for batch in batches:
            batch = {k: torch.from_numpy(v) for k, v in batch.items()}
            if not fused:
                parts = []
                for a in range(accum):
                    micro = {k: v[a::accum] for k, v in batch.items()}
                    gen = torch.Generator().manual_seed(
                        tstep._augment_seed(cfg.train.seed, state.step, a))
                    parts.append(tpre.device_preprocess(
                        cfg, micro, training=True, generator=gen))
                # Interleave the microbatches back into the strided rows.
                batch = {k: torch.stack([p[k] for p in parts], 1).flatten(0, 1)
                         for k in parts[0]}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        return losses, {k: v.detach().clone()
                        for k, v in state.model.core.named_parameters()}

    with torch.random.fork_rng():
        torch.use_deterministic_algorithms(True)
        try:
            fused_losses, fused_params = run(True)
            plain_losses, plain_params = run(False)
        finally:
            torch.use_deterministic_algorithms(False)
    assert fused_losses == plain_losses
    for name, p in plain_params.items():
        assert torch.equal(fused_params[name], p), name
