"""The pretrained-backbone converters of the PyTorch port against
``tpudet``'s, on the CPU: ``convert_torch_resnet`` (ResNet-18 and -50),
``convert_torch_vgg16`` and ``convert_torch_vit`` (with and without a cls
token, the position grid grown and shrunk) on seeded state dicts in the
torchvision and timm layouts (``chip_smoke``'s generators, as the card's
``backbones_cli`` phase converts them); ``save_backbone_npz`` and
``load_backbone_npz`` both ways between the packages;
``apply_backbone_weights``' refusals; the features of a model loaded from
an npz against tpudet's from the same npz; the Keras converters (where
TensorFlow is installed); and ``cli.train --backbone-weights``.

Tolerances: every converted leaf exactly equal to tpudet's, but
``pos_embed`` after a resize within 1e-6 (torch's antialiased bilinear
against ``jax.image.resize``); features within 1e-5 of each level's
largest magnitude (relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpudet import config as jconfig
from tpudet.models import build_model as jax_build
from tpudet.models import import_weights as jiw
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models import import_weights as tiw

torch.set_num_threads(2)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_same_trees(port, ref, pos_tol=0.0):
    port, ref = flat(port), flat(ref)
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].dtype == np.float32 and port[k].shape == ref[k].shape, k
        if k.endswith("pos_embed") and pos_tol:
            np.testing.assert_allclose(port[k], ref[k], rtol=0, atol=pos_tol)
        else:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


# -------------------------------------------------------------- converters
@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_convert_torch_resnet_equals_jax(name):
    sd = chip_smoke.torchvision_resnet_state_dict(name, seed=1)
    port = tiw.convert_torch_resnet(sd, name)
    ref = jiw.convert_torch_resnet(sd, name)
    for p, r in zip(port, ref):
        assert_same_trees(p, r)
    # numpy arrays convert as tensors do.
    port_np = tiw.convert_torch_resnet({k: v.numpy() for k, v in sd.items()},
                                       name)
    assert_same_trees(port_np[0], ref[0])


def test_convert_torch_vgg16_equals_jax():
    sd = chip_smoke.torchvision_vgg16_state_dict(seed=2)
    port, ref = tiw.convert_torch_vgg16(sd), jiw.convert_torch_vgg16(sd)
    assert port[1] == ref[1] == {}
    assert_same_trees(port[0], ref[0])


@pytest.mark.parametrize("grid,pos_grid,cls_token", [
    (14, 64, True), (14, 14, False), (16, 8, True), (8, 12, False)])
def test_convert_torch_vit_equals_jax(grid, pos_grid, cls_token):
    """The fused qkv split, the cls token dropped and the grid resized
    (14 -> 64 grows as a ViT-B/16 at 224 px does for coco_vitdet_b; 16 -> 8
    shrinks, where jax.image.resize antialiases)."""
    sd = chip_smoke.timm_vit_state_dict(32, 2, grid, seed=3,
                                        cls_token=cls_token)
    port = tiw.convert_torch_vit(sd, pos_grid=pos_grid)
    ref = jiw.convert_torch_vit(sd, pos_grid=pos_grid)
    assert port[1] == ref[1] == {}
    assert port[0]["pos_embed"].shape == (1, pos_grid, pos_grid, 32)
    assert_same_trees(port[0], ref[0], pos_tol=1e-6)


def test_convert_torch_vit_refuses_a_non_square_grid():
    sd = chip_smoke.timm_vit_state_dict(32, 1, 4, seed=4, cls_token=False)
    sd["pos_embed"] = sd["pos_embed"][:, :15]
    with pytest.raises(ValueError, match="not a square grid") as port:
        tiw.convert_torch_vit(sd, pos_grid=8)
    with pytest.raises(ValueError, match="not a square grid") as ref:
        jiw.convert_torch_vit(sd, pos_grid=8)
    assert str(port.value) == str(ref.value)


# --------------------------------------------------------------------- npz
def test_npz_written_by_either_package_loads_in_both(tmp_path):
    params, constants = tiw.convert_torch_resnet(
        chip_smoke.torchvision_resnet_state_dict("resnet18", seed=5),
        "resnet18")
    tiw.save_backbone_npz(str(tmp_path / "port.npz"), params, constants)
    jiw.save_backbone_npz(str(tmp_path / "jax.npz"), params, constants)
    for path in ("port.npz", "jax.npz"):
        for load in (tiw.load_backbone_npz, jiw.load_backbone_npz):
            p, c = load(str(tmp_path / path))
            assert_same_trees(p, params)
            assert_same_trees(c, constants)


# ------------------------------------------------------------------ apply
def r50_configs(**backbone):
    """tiny_test_config with a frozen-BN ResNet-50 (torchvision's stride)
    in both packages."""
    fields = dict(name="resnet50", norm="frozen_bn", stride_in_1x1=False,
                  **backbone)
    return [c.replace(backbone=dataclasses.replace(c.backbone, **fields))
            for c in (jconfig.tiny_test_config(),
                      tconfig.tiny_test_config())]


def test_apply_backbone_weights_refusals():
    _, tcfg = r50_configs()
    model = build_model(tcfg, device="cpu").init(0)
    params, constants = tiw.convert_torch_resnet(
        chip_smoke.torchvision_resnet_state_dict("resnet50", seed=6))
    bad = {**params, "stage9_block0": params["stage2_block0"]}
    with pytest.raises(KeyError, match="no parameter 'backbone.stage9"):
        tiw.apply_backbone_weights(model, bad, constants)
    small = tiw.convert_torch_resnet(
        chip_smoke.torchvision_resnet_state_dict("resnet18", seed=6),
        "resnet18")
    with pytest.raises(ValueError,
                       match="shape mismatch at backbone.stage2_block0.conv1"):
        tiw.apply_backbone_weights(model, *small)
    gn = build_model(tcfg.replace(backbone=dataclasses.replace(
        tcfg.backbone, norm="gn")), device="cpu")
    with pytest.raises(ValueError, match="norm='gn'"):
        tiw.apply_backbone_weights(gn, params, constants)
    # A refusal loads nothing.
    before = {k: v.clone() for k, v in model.core.state_dict().items()}
    with pytest.raises(ValueError):
        tiw.apply_backbone_weights(model, *small)
    for k, v in model.core.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_loaded_resnet_features_equal_jax(tmp_path):
    """A torchvision ResNet-50 through tpudet's npz into each package's
    frozen-BN model: the loaded tree is the npz's, and c4 through the neck
    equals tpudet's."""
    jcfg, tcfg = r50_configs()
    params, constants = jiw.convert_torch_resnet(
        chip_smoke.torchvision_resnet_state_dict("resnet50", seed=7))
    path = str(tmp_path / "r50.npz")
    jiw.save_backbone_npz(path, params, constants)
    jm = jax_build(jcfg)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.key(0)))
    v = jiw.apply_backbone_weights(v, *jiw.load_backbone_npz(path))
    model = build_model(tcfg, device="cpu").init(0)
    tiw.apply_backbone_weights(model, *tiw.load_backbone_npz(path))
    want = tiw.from_flax_variables({"params": {"backbone": params},
                                    "constants": {"backbone": constants}})
    state = model.core.state_dict()
    for k, x in want.items():
        assert torch.equal(state[k], x), k
    # The rest of the port's model is loaded from tpudet's tree too, so the
    # whole features compare.
    rest = {k: x for k, x in tiw.from_flax_variables(v).items()
            if not k.startswith("backbone.")}
    model.core.load_state_dict({**state, **rest})
    images = np.random.default_rng(8).normal(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    from tpudet.models.faster_rcnn import DetectorCore as JaxCore

    ref = jax.jit(lambda v, x: JaxCore(jcfg).apply(
        v, x, method=JaxCore.features))(v, jnp.asarray(images))
    with torch.no_grad():
        got = model.core.features(torch.from_numpy(images))
    want, got = np.asarray(ref["c4"]), got["c4"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_loaded_vit_features_equal_jax(tmp_path):
    """A timm ViT (12 x 12 + cls, resized to the tiny preset's 8 x 8 grid)
    through the port's npz into vitdet_tiny in both packages: the pyramid
    equals tpudet's."""
    jcfg = jconfig.tiny_vitdet_config()
    tcfg = tconfig.tiny_vitdet_config()
    sd = chip_smoke.timm_vit_state_dict(32, 2, 12, seed=9)
    params, constants = tiw.convert_torch_vit(sd, pos_grid=8)
    path = str(tmp_path / "vit.npz")
    tiw.save_backbone_npz(path, params, constants)
    jm = jax_build(jcfg)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.key(0)))
    v = jiw.apply_backbone_weights(v, *jiw.load_backbone_npz(path))
    model = build_model(tcfg, device="cpu")
    model.core.load_state_dict(tiw.from_flax_variables(
        jax.tree_util.tree_map(np.asarray, v)))
    fresh = build_model(tcfg, device="cpu").init(1)
    fresh.core.load_state_dict(model.core.state_dict())
    tiw.apply_backbone_weights(fresh, *tiw.load_backbone_npz(path))
    for k, x in model.core.state_dict().items():
        assert torch.equal(fresh.core.state_dict()[k], x), k
    images = np.random.default_rng(10).normal(0, 1, (1, 128, 128, 3)).astype(
        np.float32)
    from tpudet.models.faster_rcnn import DetectorCore as JaxCore

    ref = jax.jit(lambda v, x: JaxCore(jcfg).apply(
        v, x, method=JaxCore.features))(v, jnp.asarray(images))
    with torch.no_grad():
        got = fresh.core.features(torch.from_numpy(images))
    for name in ("p2", "p3", "p4", "p5", "p6"):
        want = np.asarray(ref[name])
        np.testing.assert_allclose(got[name].permute(0, 2, 3, 1).numpy(),
                                   want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


# ------------------------------------------------------------------ Keras
@pytest.fixture(scope="module")
def keras():
    tf = pytest.importorskip("tensorflow")
    tf.keras.utils.set_random_seed(0)
    return tf.keras


def test_convert_keras_resnet50_equals_jax(keras):
    model = keras.applications.ResNet50(weights=None, include_top=False,
                                        input_shape=(64, 64, 3))
    port = tiw.convert_keras_resnet(model, "resnet50")
    ref = jiw.convert_keras_resnet(model, "resnet50")
    for p, r in zip(port, ref):
        assert_same_trees(p, r)


def test_convert_keras_vgg16_equals_jax(keras):
    model = keras.applications.VGG16(weights=None, include_top=False,
                                     input_shape=(64, 64, 3))
    port, ref = tiw.convert_keras_vgg16(model), jiw.convert_keras_vgg16(model)
    assert port[1] == ref[1] == {}
    assert_same_trees(port[0], ref[0])


# -------------------------------------------------------------------- CLI
def test_cli_train_backbone_weights(tmp_path, capsys):
    """``cli.train --backbone-weights`` at a 128-px canvas (``--set``): a
    torchvision ResNet-50 into the frozen-BN tiny-head model; the backbone
    the CLI loaded equals the npz before the first step."""
    from tpudet_torch.cli import train as ttrain

    params, constants = tiw.convert_torch_resnet(
        chip_smoke.torchvision_resnet_state_dict("resnet50", seed=11))
    path = tmp_path / "r50.npz"
    tiw.save_backbone_npz(str(path), params, constants)
    want = tiw.from_flax_variables({"params": {"backbone": params},
                                    "constants": {"backbone": constants}})
    loaded = {}
    apply = ttrain.apply_backbone_weights

    def recording(model, p, c):
        apply(model, p, c)
        loaded.update({k: v.clone() for k, v in
                       model.core.state_dict().items()})
        return model

    argv = ["--preset", "tiny", "--dataset", "synthetic", "--device", "cpu",
            "--steps", "2", "--batch-size", "2", "--backbone-weights",
            str(path)]
    for item in ("backbone.name=resnet50", "backbone.norm=frozen_bn",
                 "backbone.stride_in_1x1=False", "data.canvas_height=128",
                 "data.canvas_width=128"):
        argv += ["--set", item]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "apply_backbone_weights", recording)
        state = ttrain.main(argv)
    assert "loaded backbone weights" in capsys.readouterr().out
    assert state.step == 2
    for k, x in want.items():
        assert torch.equal(loaded[k], x), k
