"""VGG-16 and ResNet-18/34 of the PyTorch port against ``tpudet``'s, on
the CPU: VGG's c2..c5 (and the single-level detector's early stop at c4),
its stage-2 freezing, a ``voc_vgg16``-derived Faster R-CNN on a 128-px
canvas (fc 64 instead of 4096; predict, loss terms and gradients given
JAX's sampler draws) and the ResNet-18/34 pyramids with random FrozenBN
constants.

The model's loss runs with oneDNN off (PyTorch's own CPU convolutions).
VGG has a ReLU after each of its 13 convs, and a unit whose input lies
within rounding of 0 takes the side its rounding gives it. oneDNN's f32
convolutions round further from the exact result than XLA's do: with them
the port's gradients of stages 3-5 part from tpudet's by 1e-3 to 1e-2 of
their largest magnitude on every seed tried (four), while a float64 run of
the port agrees with tpudet's f32 gradients within 1e-6. Without oneDNN
two of the four seeds agree within 1.4e-6; the other two have a unit at a
kink in stage 3 (train_batch seed 6 is one). The fixture uses seed 8.

Tolerances (f32): each pyramid level within 1e-5 of its largest magnitude
(relative); loss terms within 1e-5 relative; each gradient within 1e-4 of
its largest magnitude plus 1e-5 of its own values plus 1e-6 of the
model's largest gradient (as ``tests/test_torch_retinanet.py``); detections
as ``test_torch_faster_rcnn.assert_same_detections``.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_deformable_detr_train import train_batch
from tests.test_torch_faster_rcnn import (
    assert_same_detections,
    configs,
    random_variables,
)
from tests.test_torch_faster_rcnn_train import jax_draws, t
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.models import build_model as jax_build
from tpudet.models.resnet import build_backbone as jax_backbone
from tpudet.models.vgg import VGG as JaxVGG
from tpudet_torch.cli.common import preset_config
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.models.resnet import ResNet, build_backbone
from tpudet_torch.models.vgg import VGG
from tpudet_torch.train.step import make_eval_step

torch.set_num_threads(2)
LEVELS = ("c2", "c3", "c4", "c5")


def nchw(images):
    return t(images).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def assert_level_close(port, ref, label):
    ref = np.asarray(ref)
    got = port.permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == ref.shape, label
    assert np.abs(ref).max() > 0, label
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max(), err_msg=label)


def random_constants(v, seed):
    """FrozenBN statistics drawn away from the identity."""
    rng = np.random.default_rng(seed)
    v = flax.core.unfreeze(jax.tree_util.tree_map(np.asarray, v))
    flat = flax.traverse_util.flatten_dict(v["constants"])
    for key, leaf in flat.items():
        lo, hi = (0.5, 1.5) if key[-1] in ("scale", "var") else (-0.1, 0.1)
        flat[key] = rng.uniform(lo, hi, leaf.shape).astype(np.float32)
    v["constants"] = flax.traverse_util.unflatten_dict(flat)
    return v


# --------------------------------------------------------------- backbones
def test_vgg_pyramid_equals_jax():
    images = np.random.default_rng(0).normal(0, 1, (2, 64, 96, 3)).astype(
        np.float32)
    jvgg = JaxVGG()
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jvgg.init)(
        jax.random.key(0), jnp.asarray(images)))
    ref = jax.jit(jvgg.apply)(v, jnp.asarray(images))
    vgg = VGG()
    vgg.load_state_dict(from_flax_variables(
        {"params": v["params"]}))  # strict: the Flax names
    assert vgg.channels == {name: ref[name].shape[-1] for name in LEVELS}
    with torch.no_grad():
        feats = vgg(nchw(images))
        c4_only = vgg(nchw(images), stop_at="c4")
    assert sorted(feats) == sorted(ref) == list(LEVELS)
    assert sorted(c4_only) == ["c2", "c3", "c4"]
    for name in LEVELS:
        assert_level_close(feats[name], ref[name], name)
    np.testing.assert_array_equal(c4_only["c4"].numpy(), feats["c4"].numpy())


@pytest.mark.parametrize("freeze_stem", [True, False])
def test_vgg_freezes_stages_1_and_2(freeze_stem):
    vgg = build_backbone("vgg16", "frozen_bn", torch.float32,
                         freeze_stem=freeze_stem)
    from tpudet_torch.models.layers import init_module

    init_module(vgg, torch.Generator().manual_seed(0))
    feats = vgg(torch.rand(1, 3, 64, 64))
    sum(f.float().sum() for f in feats.values()).backward()
    for name, p in vgg.named_parameters():
        stem = name.startswith(("stage1.", "stage2."))
        if stem and freeze_stem:
            assert p.grad is None, name
        else:
            assert p.grad is not None and p.grad.abs().max() > 0, name


@pytest.mark.parametrize("name", ["resnet18", "resnet34"])
def test_basic_block_resnet_pyramid_equals_jax(name):
    """ResNet-18/34 of basic blocks (64..512 wide) with random FrozenBN
    statistics; ``stride_in_1x1`` is ignored by basic blocks in both
    packages."""
    images = np.random.default_rng(1).normal(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jnet = jax_backbone(name, "frozen_bn", jnp.float32, True)
    v = random_constants(jax.jit(jnet.init)(jax.random.key(1),
                                            jnp.asarray(images)), 2)
    ref = jax.jit(jnet.apply)(v, jnp.asarray(images))
    for stride_in_1x1 in (True, False):
        net = build_backbone(name, "frozen_bn", torch.float32,
                             stride_in_1x1=stride_in_1x1)
        assert isinstance(net, ResNet)
        net.load_state_dict(from_flax_variables(v))
        with torch.no_grad():
            feats = net(nchw(images))
        for level in LEVELS:
            assert_level_close(feats[level], ref[level], f"{name} {level}")
    assert net.channels == {"c2": 64, "c3": 128, "c4": 256, "c5": 512}


def test_unknown_backbone_is_refused():
    with pytest.raises(ValueError, match="unknown backbone 'resnet152'"):
        build_backbone("resnet152", "frozen_bn", torch.float32)


# ------------------------------------------------------------------- model
def vgg_configs():
    """voc_vgg16's widths (VGG-16, neck 256, RPN 512, 9 anchors, 20
    classes) on a 128-px canvas, fc 64."""
    pcfg = preset_config("voc_vgg16")
    assert pcfg.backbone.name == "vgg16" and pcfg.roi.fc_dim == 4096
    return configs("default", data=dict(num_classes=20, canvas_height=128,
                                        canvas_width=128),
                   backbone=dict(name="vgg16"), roi=dict(fc_dim=64))


@pytest.fixture(scope="module")
def run():
    jcfg, tcfg = vgg_configs()
    jm = jax_build(jcfg)
    init = jax.jit(jm.init)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "init", init)
        v = random_variables(jm, 4)
    tm = build_model(tcfg, device="cpu")
    tm.core.load_state_dict(from_flax_variables(v))  # strict
    batch = train_batch(tcfg, seed=8)
    rng = jax.random.key(7)

    def loss(params):
        return jm.loss({**v, "params": params}, batch, rng)

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    shapes = tm.draw_shapes(2, batch["image"].shape[1:3])
    draws = jax_draws(rng, 2, shapes["rpn"][1], shapes["roi"][1])
    with torch.backends.mkldnn.flags(enabled=False):  # see the docstring
        total, port = tm.loss({k: t(x) for k, x in batch.items()},
                              draws=draws)
        total.backward()
    return dict(jm=jm, v=v, tm=tm, jcfg=jcfg, tcfg=tcfg,
                metrics=({k: float(x) for k, x in metrics.items()},
                         {k: float(x.detach()) for k, x in port.items()}),
                grads=from_flax_variables({"params": grads}))


def test_vgg_faster_rcnn_loss_terms_equal_jax(run):
    ref, port = run["metrics"]
    assert set(port) == set(ref)
    for k in ref:
        assert port[k] == pytest.approx(ref[k], rel=1e-5), k
    assert ref["num_fg_rois"] > 0 and ref["det_box_loss"] > 0


def test_vgg_faster_rcnn_gradients_equal_jax(run):
    tm, ref_grads = run["tm"], run["grads"]
    assert set(n for n, _ in tm.core.named_parameters()) == set(ref_grads)
    floor = 1e-6 * max(float(g.abs().max()) for g in ref_grads.values())
    for name, p in tm.core.named_parameters():
        want = ref_grads[name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-4 * np.abs(want).max() + floor,
                                   err_msg=name)
    # The preset freezes conv1 and conv2 (VGG's freeze_stem): no gradient.
    assert run["tcfg"].backbone.freeze_stem
    assert tm.core.backbone.stage2.conv2_2.weight.grad is None
    assert tm.core.backbone.stage3.conv3_1.weight.grad.abs().max() > 0


def test_vgg_faster_rcnn_predict_equals_jax(run):
    jm, v, tm = run["jm"], run["v"], run["tm"]
    rng = np.random.default_rng(8)
    batch = {"image": rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8),
             "image_hw": np.array([[128, 128], [96, 128]], np.float32)}
    ref = jax.jit(lambda v, bt: jm.predict(v, jax_preprocess(run["jcfg"],
                                                             bt)))(v, batch)
    ref = {k: np.asarray(x) for k, x in ref.items()}
    out = {k: x.numpy()
           for k, x in make_eval_step(tm, run["tcfg"])(batch).items()}
    assert set(out) == set(ref)
    assert (ref["num_detections"] > 3).all()
    assert_same_detections(out, ref)


def test_voc_vgg16_preset_builds_the_paper_model():
    """voc_vgg16 at full width: VGG-16 to conv5_3 (512) through the 256
    neck, fc6 of 7 * 7 * 256 -> 4096."""
    cfg = preset_config("voc_vgg16")
    core = build_model(cfg, device="cpu").core
    assert isinstance(core.backbone, VGG) and core.fpn is None
    assert core.neck_conv.weight.shape == (256, 512, 1, 1)
    assert core.det_head.fc1.weight.shape == (4096, 7 * 7 * 256)
    assert dataclasses.asdict(cfg.backbone)["freeze_stem"]
