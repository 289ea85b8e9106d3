"""The JAX package's model options in the PyTorch port, on the CPU:
``backbone.s2d_stem``, ``backbone.remat`` and
``deformable_detr.shared_sampling_locations``.

* ``s2d_stem``: the 4x4/1 stem on the block-2 space-to-depth image with
  converted weights equals the standard 7x7/2 stem (the port's converter
  equals tpudet's through ``from_flax_variables``), and the s2d ResNet
  equals tpudet's s2d ResNet;
* ``remat``: recomputing the ResNet blocks, the ViT blocks and the VGG
  stages leaves the loss and every gradient as they were (each block runs
  through ``torch.utils.checkpoint``), and inference is unaffected;
* head-shared sampling locations (the patch gather): the loss, the
  gradients and the predict equal tpudet's with the same converted
  weights, and the option without ``"patch"`` raises tpudet's
  ``ValueError``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from tests.test_torch_deformable_detr_predict import (
    assert_same_detections,
    configs as deformable_configs,
    predict_both,
    uint8_batch,
    widened,
)
from tests.test_torch_deformable_detr_train import train_batch
from tpudet.models import DeformableDETR as JaxDeformableDETR
from tpudet.models.resnet import ResNet as JaxResNet
from tpudet.models.resnet import convert_params_to_s2d as jax_to_s2d
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.models.resnet import (
    ResNet,
    convert_params_to_s2d,
    space_to_depth,
)

torch.set_num_threads(2)


def test_space_to_depth_is_the_jax_channel_order():
    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    from tpudet.models.resnet import space_to_depth as jax_s2d

    want = np.asarray(jax_s2d(jnp.asarray(x), 2))              # NHWC
    got = space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2))  # NCHW
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_s2d_stem_equals_standard_stem_and_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    blocks = (1, 1, 1, 1)  # the stem is what differs
    std = JaxResNet(blocks=blocks, norm="gn", freeze_stem=False)
    s2d = JaxResNet(blocks=blocks, norm="gn", freeze_stem=False,
                    s2d_stem=True)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(std.init)(jax.random.key(0), jnp.asarray(x))[
            "params"])
    ref = jax.jit(s2d.apply)({"params": jax_to_s2d(params)}, jnp.asarray(x))
    port_std = ResNet(blocks, norm="gn", freeze_stem=False)
    port_s2d = ResNet(blocks, norm="gn", freeze_stem=False, s2d_stem=True)
    sd = from_flax_variables({"params": params})
    port_std.load_state_dict(sd)
    converted = convert_params_to_s2d(sd)
    # The port's converter is tpudet's through the weight map.
    assert torch.equal(converted["stem_conv.weight"], from_flax_variables(
        {"params": jax_to_s2d(params)})["stem_conv.weight"])
    assert converted["stem_conv.weight"].shape == (64, 12, 4, 4)
    port_s2d.load_state_dict(converted)
    image = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        got, std_out = port_s2d(image), port_std(image)
    for level in ("c2", "c3", "c4", "c5"):
        np.testing.assert_allclose(got[level].numpy(), std_out[level].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=level)
        np.testing.assert_allclose(got[level].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref[level]), rtol=1e-4,
                                   atol=1e-4, err_msg=level)


def test_s2d_stem_model_builds_and_loads_flax_s2d_kernels():
    cfg = tconfig.tiny_test_config()
    cfg = cfg.replace(backbone=dataclasses.replace(
        cfg.backbone, name="resnet18", s2d_stem=True),
        data=dataclasses.replace(cfg.data, canvas_height=64,
                                 canvas_width=64))
    model = build_model(cfg, device="cpu").init(0)
    assert model.core.backbone.stem_conv.weight.shape == (64, 12, 4, 4)
    k = np.random.default_rng(0).normal(size=(4, 4, 12, 64)).astype(
        np.float32)
    sd = from_flax_variables({"params": {"backbone": {"stem_conv": {
        "kernel": k}}}})
    np.testing.assert_array_equal(sd["backbone.stem_conv.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))


def remat_config(kind):
    cfg = (tconfig.tiny_vitdet_config() if kind == "vit_tiny"
           else tconfig.tiny_test_config())
    if kind != "vit_tiny":
        cfg = cfg.replace(
            backbone=dataclasses.replace(cfg.backbone, name=kind,
                                         freeze_stem=False),
            data=dataclasses.replace(cfg.data, canvas_height=64,
                                     canvas_width=64))
    return cfg


@pytest.mark.parametrize("kind,blocks", [("resnet18", 6), ("vit_tiny", 2),
                                         ("vgg16", 5)])
def test_remat_keeps_loss_and_gradients(kind, blocks, monkeypatch):
    cfg = remat_config(kind)
    batch = {k: torch.from_numpy(x) for k, x in train_batch(cfg, seed=2).items()}
    results = {}
    calls = []
    original = torch.utils.checkpoint.checkpoint

    def counting(fn, *args, **kw):
        calls.append(type(fn).__name__)
        return original(fn, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    for remat in (False, True):
        c = cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                     remat=remat))
        model = build_model(c, device="cpu").init(0)
        draws = model.draw_samples(torch.Generator().manual_seed(1), 2,
                                   batch["image"].shape[1:3])
        total, metrics = model.loss(batch, draws=draws)
        total.backward()
        with torch.no_grad():
            model.eval()
            pred = model.predict(batch)
        results[remat] = (float(total.detach()), {
            n: p.grad.clone() for n, p in model.core.named_parameters()
            if p.grad is not None}, pred)
    assert len(calls) == blocks  # once per block, in the remat run
    (loss0, g0, p0), (loss1, g1, p1) = results[False], results[True]
    assert loss1 == loss0
    assert set(g0) == set(g1) and any(n.startswith("backbone") for n in g0)
    for n, g in g0.items():
        torch.testing.assert_close(g1[n], g, rtol=1e-6, atol=1e-7, msg=n)
    for k, x in p0.items():
        assert torch.equal(p1[k], x), k


@pytest.fixture(scope="module")
def shared_pair():
    jcfg, tcfg = deformable_configs(sampling_gather="patch",
                                    shared_sampling_locations=True)
    jm = JaxDeformableDETR(jcfg)
    v = widened(jax.jit(jm.init)(jax.random.key(4)), 4,
                jcfg.deformable_detr.d_model)
    tm = build_model(tcfg, device="cpu")
    tm.core.load_state_dict(from_flax_variables(v))
    return jm, v, jcfg, tm, tcfg


def test_shared_locations_loss_and_gradients_equal_jax(shared_pair):
    jm, v, _, tm, tcfg = shared_pair
    offsets = tm.core.enc0.deform_attn.sampling_offsets
    d = tcfg.deformable_detr
    assert offsets.weight.shape == (d.num_levels * d.num_points * 2,
                                    d.d_model)
    batch = train_batch(tcfg)

    def loss(params):
        return jm.loss({"params": params}, batch, jax.random.key(0))

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    grads = from_flax_variables({"params": grads})
    total, port = tm.loss({k: torch.from_numpy(x) for k, x in batch.items()})
    for k, x in metrics.items():
        assert float(port[k].detach()) == pytest.approx(float(x), rel=1e-5), k
    total.backward()
    assert set(grads) == {n for n, _ in tm.core.named_parameters()}
    floor = 1e-6 * max(float(g.abs().max()) for g in grads.values())
    for name, p in tm.core.named_parameters():
        want = grads[name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-4 * np.abs(want).max() + floor,
                                   err_msg=name)
    assert offsets.weight.grad.abs().max() > 0


def test_shared_locations_predict_equals_jax(shared_pair):
    jm, v, jcfg, tm, tcfg = shared_pair
    out, ref = predict_both(jm, v, jcfg, tm, tcfg, uint8_batch(2))
    assert (ref["num_detections"] > 5).all()
    assert_same_detections(out, ref)


def test_shared_locations_init_is_the_head_free_probe():
    _, tcfg = deformable_configs(sampling_gather="patch",
                                 shared_sampling_locations=True)
    jm_cfg, _ = deformable_configs(sampling_gather="patch",
                                   shared_sampling_locations=True)
    jm = JaxDeformableDETR(jm_cfg)
    v = jax.jit(jm.init)(jax.random.key(0))
    want = np.asarray(v["params"]["enc0"]["deform_attn"]["sampling_offsets"][
        "bias"])
    core = build_model(tcfg, device="cpu").init(0).core
    np.testing.assert_allclose(
        core.enc0.deform_attn.sampling_offsets.bias.detach().numpy(), want,
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="patch"):
        build_model(tcfg.replace(deformable_detr=dataclasses.replace(
            tcfg.deformable_detr, sampling_gather="flat")), device="cpu")
