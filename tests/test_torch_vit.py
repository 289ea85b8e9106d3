"""ViTDet of the PyTorch port against ``tpudet``'s, on the CPU: the window
partition, a window covering the grid against global attention, the
position embedding's resize against ``jax.image.resize``, the ViT and the
simple feature pyramid level by level, the refusals, ``vitdet_tiny``'s
predict, loss terms and gradients (given JAX's sampler draws), the frozen
stem, the AdamW decay mask, Mask R-CNN on ``vit_tiny``, a bf16 block and
the three CLIs (the tiny learning check: ``test_torch_vit_learning.py``).

Weights: Flax's init through ``from_flax_variables`` with
``test_torch_faster_rcnn.random_variables``' widened heads.

Tolerances (f32): the partition exactly equal; the resize within 1e-6;
a covering window against global attention within 1e-5; the ViT's plain
map and each pyramid level within 1e-5 of the level's largest magnitude
(relative); loss terms within 1e-5 relative; each gradient within 1e-4 of
its largest magnitude plus 1e-5 of its own values plus 1e-6 of the model's
largest gradient (as ``tests/test_torch_retinanet.py``); detections as
``test_torch_faster_rcnn.assert_same_detections`` and Mask R-CNN's masks
within 1e-5. bf16: a block within 2^-5 of its largest magnitude (the rule
of ``tests/test_torch_bf16_parity.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_deformable_detr_train import train_batch
from tests.test_torch_faster_rcnn import assert_same_detections, random_variables
from tests.test_torch_faster_rcnn_train import jax_draws, t
from tests.test_torch_retinanet import cli_train_eval_detect
from tpudet import config as jconfig
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.models import build_model as jax_build
from tpudet.models import vit as jvit
from tpudet.models.faster_rcnn import DetectorCore as JaxCore
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models import vit as tvit
from tpudet_torch.models.import_weights import (
    flax_param_ndims,
    from_flax_variables,
)
from tpudet_torch.train.step import make_eval_step

torch.set_num_threads(2)
METRICS = {"loss", "rpn_cls_loss", "rpn_box_loss", "det_cls_loss",
           "det_box_loss", "num_pos_anchors", "num_fg_rois"}


def vit_pair(jcfg, tcfg, seed):
    """tpudet's model, ``random_variables``' weights (its init jitted: an
    eager Flax init compiles every primitive) and the port's model."""
    jm = jax_build(jcfg)
    init = jax.jit(jm.init)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "init", init)
        v = random_variables(jm, seed)
    tm = build_model(tcfg, device="cpu")
    tm.core.load_state_dict(from_flax_variables(v))  # strict
    return jm, v, tm


def both(fn):
    """``fn(config module)`` for tpudet's and the port's config."""
    return fn(jconfig), fn(tconfig)


# ----------------------------------------------------------------- blocks
@pytest.mark.parametrize("h,w,win", [(8, 8, 4), (7, 9, 4), (3, 3, 4),
                                     (8, 12, 3)])
def test_window_partition_equals_jax(h, w, win):
    x = np.random.default_rng(0).normal(size=(2, h, w, 5)).astype(np.float32)
    ref, ref_pad = jvit._window_partition(jnp.asarray(x), win)
    out, pad = tvit._window_partition(t(x), win)
    assert pad == ref_pad
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    back = tvit._window_unpartition(out, win, pad, (h, w), 2)
    np.testing.assert_array_equal(back.numpy(), x)


def test_window_covering_grid_equals_global():
    """One block with a window of the grid's side computes the global
    block's attention (no padding, one window)."""
    kw = dict(dim=32, depth=1, heads=2, pos_grid=8)
    windowed = tvit.ViT(window=8, global_attn_every=10**9, **kw)
    global_ = tvit.ViT(window=8, global_attn_every=1, **kw)
    assert windowed.block0.window == 8 and global_.block0.window == 0
    g = torch.Generator().manual_seed(0)
    from tpudet_torch.models.layers import init_module

    init_module(windowed, g)
    windowed.reset_parameters(g)
    global_.load_state_dict(windowed.state_dict())
    x = torch.rand(1, 3, 128, 128)
    with torch.no_grad():
        np.testing.assert_allclose(windowed(x)["plain"].numpy(),
                                   global_(x)["plain"].numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grid,out", [(8, (8, 8)), (8, (10, 10)),
                                      (8, (6, 6)), (64, (52, 52)),
                                      (64, (52, 84)), (64, (84, 84))])
def test_pos_embed_resize_equals_jax_image_resize(grid, out):
    """``jax.image.resize(..., "bilinear")`` antialiases when it shrinks;
    the port's resize is torch's antialiased bilinear."""
    pos = np.random.default_rng(1).normal(0, 0.02, (1, grid, grid, 8)
                                          ).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(pos), (1, *out, 8),
                                      "bilinear"))
    got = tvit.resize_pos_embed(t(pos), out).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_bf16_block_within_the_bf16_rule():
    dim, heads = 32, 2
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 6, 10, dim)).astype(np.float32)
    for window in (4, 0):
        jblock = jvit.Block(dim, heads, window, dtype=jnp.bfloat16)
        xb = jnp.asarray(x, jnp.bfloat16)
        v = jax.tree_util.tree_map(np.asarray, jax.jit(jblock.init)(
            jax.random.key(3), xb))
        ref = np.asarray(jax.jit(jblock.apply)(v, xb), np.float32)
        block = tvit.Block(dim, heads, window, dtype=torch.bfloat16)
        block.load_state_dict(from_flax_variables(v))
        with torch.no_grad():
            out = block(t(x).to(torch.bfloat16)).float().numpy()
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=2 ** -5 * np.abs(ref).max())


# ---------------------------------------------------------------- pyramid
@pytest.mark.parametrize("canvas", [(128, 128), (96, 160)])
def test_vit_and_pyramid_equal_jax_per_level(canvas):
    """The plain map and p2..p6 of ``vitdet_tiny``; the 96x160 canvas is a
    6x10 token grid (the position grid resized both ways, windows of 4
    padded)."""
    jcfg, tcfg = both(lambda m: m.tiny_vitdet_config())
    jm, v, tm = vit_pair(jcfg, tcfg, seed=1)
    images = np.random.default_rng(3).normal(0, 1, (2, *canvas, 3)).astype(
        np.float32)

    def features(core, x):
        plain = core.backbone(x)
        return plain["plain"], core.fpn(plain)

    ref_plain, ref = jax.jit(lambda v, x: JaxCore(jcfg).apply(
        v, x, method=features))(v, jnp.asarray(images))
    with torch.no_grad():
        x = t(images).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        plain = tm.core.backbone(x)["plain"]
        feats = tm.core.features(t(images))
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref_plain),
                               rtol=1e-5,
                               atol=1e-5 * np.abs(ref_plain).max())
    assert sorted(feats) == sorted(ref) == ["p2", "p3", "p4", "p5", "p6"]
    for name, stride in (("p2", 4), ("p3", 8), ("p4", 16), ("p5", 32),
                         ("p6", 64)):
        want = np.asarray(ref[name])
        got = feats[name].permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (2, -(-canvas[0] // stride),
                                           -(-canvas[1] // stride), 256)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
        if name != "p6":
            # The maps are channels-last in memory: their NHWC view is
            # contiguous, as the RoI Align kernels read it.
            assert feats[name].permute(0, 2, 3, 1).is_contiguous(), name


@pytest.mark.parametrize("case,match", [("canvas", "divisible"),
                                        ("no_fpn", "use_fpn")])
def test_refusals_as_jax(case, match):
    jcfg, tcfg = both(lambda m: m.tiny_vitdet_config())
    if case == "canvas":
        vit = tvit.ViT(dim=32, depth=1, heads=2)
        with pytest.raises(ValueError, match=match) as port:
            vit(torch.ones(1, 3, 130, 128))
        with pytest.raises(ValueError, match=match) as ref:
            jvit.ViT(dim=32, depth=1, heads=2).init(
                jax.random.key(0), jnp.ones((1, 130, 128, 3)))
    else:
        jcfg, tcfg = (c.replace(backbone=dataclasses.replace(
            c.backbone, use_fpn=False)) for c in (jcfg, tcfg))
        with pytest.raises(ValueError, match=match) as port:
            build_model(tcfg, device="cpu")
        with pytest.raises(ValueError, match=match) as ref:
            jax_build(jcfg).init(jax.random.key(0))
    assert str(port.value) == str(ref.value)


# ------------------------------------------------------------------ model
@pytest.fixture(scope="module")
def run():
    """tpudet's loss, metrics and gradients of ``vitdet_tiny`` on one
    batch, and the port's loss given the same draws."""
    jcfg, tcfg = both(lambda m: m.tiny_vitdet_config())
    jm, v, tm = vit_pair(jcfg, tcfg, seed=2)
    batch = train_batch(tcfg, seed=3)
    rng = jax.random.key(5)

    def loss(params):
        return jm.loss({**v, "params": params}, batch, rng)

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    shapes = tm.draw_shapes(2, batch["image"].shape[1:3])
    draws = jax_draws(rng, 2, shapes["rpn"][1], shapes["roi"][1])
    total, port = tm.loss({k: t(x) for k, x in batch.items()}, draws=draws)
    total.backward()
    return dict(tm=tm, tcfg=tcfg, batch=batch, draws=draws,
                metrics=({k: float(x) for k, x in metrics.items()},
                         {k: float(x.detach()) for k, x in port.items()}),
                grads=from_flax_variables({"params": grads}))


def test_loss_terms_equal_jax(run):
    ref, port = run["metrics"]
    assert set(port) == set(ref) == METRICS
    for k in ref:
        assert port[k] == pytest.approx(ref[k], rel=1e-5), k
    assert ref["num_fg_rois"] > 0 and ref["det_box_loss"] > 0


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


@pytest.mark.parametrize("frozen", [False, True])
def test_stem_freezing_and_every_block_trains(run, frozen):
    """Every block's attention and MLP get a gradient; with
    ``freeze_stem`` the patch and position embeddings get none and the
    rest get the trained stem's."""
    tm = run["tm"]
    if frozen:
        cfg = run["tcfg"]
        cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                       freeze_stem=True))
        trained, tm = tm, build_model(cfg, device="cpu")
        tm.core.load_state_dict(trained.core.state_dict())
        tm.loss({k: t(x) for k, x in run["batch"].items()},
                draws=run["draws"])[0].backward()
        for name, p in tm.core.named_parameters():
            if "patch_embed" not in name and "pos_embed" not in name:
                want = trained.core.get_parameter(name).grad
                np.testing.assert_allclose(p.grad.numpy(), want.numpy(),
                                           rtol=1e-5, atol=1e-7,
                                           err_msg=name)
    bb = tm.core.backbone
    for name in ("patch_embed.weight", "patch_embed.bias", "pos_embed"):
        grad = bb.get_parameter(name).grad
        if frozen:
            assert grad is None, name
        else:
            assert grad.abs().max() > 0, name
    for i in range(bb.depth):
        block = getattr(bb, f"block{i}")
        for layer in (block.attn.query, block.attn.value, block.attn.out,
                      block.mlp_fc1, block.mlp_fc2):
            assert layer.weight.grad.abs().max() > 0, f"block{i}"


def test_predict_equals_jax():
    """make_eval_step (uint8 canvases, fused preprocess) against tpudet's
    predict, on a canvas that resizes the position grid and pads the
    windows."""
    jcfg, tcfg = both(lambda m: m.tiny_vitdet_config())
    jm, v, tm = vit_pair(jcfg, tcfg, seed=6)
    rng = np.random.default_rng(7)
    for h, w in ((96, 160),):
        batch = {"image": rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8),
                 "image_hw": np.array([[h, w], [h * 0.75, w]], np.float32)}
        ref = jax.jit(lambda v, bt: jm.predict(v, jax_preprocess(jcfg, bt)))(
            v, batch)
        ref = {k: np.asarray(x) for k, x in ref.items()}
        out = {k: x.numpy() for k, x in make_eval_step(tm, tcfg)(batch).items()}
        assert set(out) == set(ref)
        assert (ref["num_detections"] > 3).all()
        assert_same_detections(out, ref)


def test_adamw_decay_mask_equals_jax():
    """optax decays the leaves of ndim >= 2 in the Flax tree: pos_embed
    (4-D) and every Dense and conv kernel; not the LayerNorms or biases."""
    jcfg = jconfig.tiny_vitdet_config()
    v = jax.eval_shape(jax_build(jcfg).init, jax.random.key(0))
    ref = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(v["params"])[0]:
        keys = [p.key for p in path]
        keys[-1] = {"kernel": "weight", "scale": "weight"}.get(keys[-1],
                                                               keys[-1])
        ref[".".join(keys)] = len(leaf.shape)
    tm = build_model(tconfig.tiny_vitdet_config(), device="cpu")
    ndims = flax_param_ndims(tm.core)
    assert ndims == ref
    assert tm.core.backbone.pos_embed.shape == (1, 8, 8, 32)
    assert ndims["backbone.pos_embed"] == 4
    assert ndims["backbone.block0.attn.query.weight"] == 2
    assert ndims["backbone.block0.norm1.weight"] == 1


def test_mask_rcnn_on_vit_equals_jax():
    """The ViT under Mask R-CNN through the shared p2..p6 contract."""
    def cfg_of(m):
        base = m.tiny_maskrcnn_config()
        return base.replace(backbone=dataclasses.replace(
            base.backbone, name="vit_tiny", use_fpn=True, vit_window=4,
            vit_global_attn_every=2, vit_pos_grid=8))

    jcfg, tcfg = both(cfg_of)
    jm, v, tm = vit_pair(jcfg, tcfg, seed=9)
    rng = np.random.default_rng(10)
    batch = {"image": rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8),
             "image_hw": np.array([[128, 128], [96, 112]], np.float32)}
    ref = jax.jit(lambda v, bt: jm.predict(v, jax_preprocess(jcfg, bt)))(
        v, batch)
    ref = {k: np.asarray(x) for k, x in ref.items()}
    out = {k: x.numpy() for k, x in make_eval_step(tm, tcfg)(batch).items()}
    assert "masks" in out and set(out) == set(ref)
    assert (ref["num_detections"] > 3).all()
    assert_same_detections(out, ref)
    for b in range(2):
        n = int(ref["num_detections"][b])
        np.testing.assert_allclose(out["masks"][b, :n], ref["masks"][b, :n],
                                   atol=1e-5)


# ------------------------------------------------------------------- CLIs
def test_cli_train_eval_detect(tmp_path, capsys):
    _, boxes = cli_train_eval_detect(
        tmp_path, capsys, "vitdet_tiny", "det_cls_loss=",
        ["roi.score_thresh=0.0"])
    assert len(boxes) > 0
