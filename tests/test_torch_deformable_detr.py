"""Deformable DETR modules of the PyTorch port against their Flax
counterparts, with weights carried over by ``from_flax_variables``, on the
CPU (the deformable attention runs through the kernel module's plain
version there).

Weights start from Flax's init and are redrawn where the init would hide a
fault: the offset and attention-weight kernels are zero at init (every
query would sample the same directional probe with uniform weights), the
last box layer is zero, LayerNorm and the masked GroupNorm are the
identity.

Tolerances, f32: ``atol 1e-5`` on module outputs of order 1 (the two
frameworks sum the dense layers and the sampled corners in other orders;
measured within ~2e-6). bf16: see ``test_bf16_modules_close_to_jax``.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.models import deformable_detr as jdd
from tpudet.models.detr import sine_position_embedding as jax_sine
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models import deformable_detr as tdd
from tpudet_torch.models.detr import sine_position_embedding
from tpudet_torch.models.import_weights import from_flax_variables

torch.set_num_threads(2)
ATOL = 1e-5
SHAPES = ((6, 8), (3, 4), (2, 2))  # three levels: 48 + 12 + 4 tokens


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), rtol=0, atol=atol)


def randomized(variables, seed, std=0.2):
    """Every parameter redrawn: N(0, std) kernels and biases, scales near 1,
    the offset bias kept (the directional probe) plus noise."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(
        flax.core.unfreeze(jax.tree_util.tree_map(np.asarray, variables))[
            "params"])
    for key, leaf in flat.items():
        draw = rng.normal(0, std, leaf.shape)
        if key[-1] == "scale":
            draw = 1.0 + draw
        elif key[-2:] == ("sampling_offsets", "bias"):
            draw = leaf + draw
        flat[key] = draw.astype(np.float32)
    return {"params": flax.traverse_util.unflatten_dict(flat)}


def port_module(module, variables):
    module.load_state_dict(from_flax_variables(variables))  # strict
    return module.eval().requires_grad_(False)


def attn_inputs(seed, b=2, nq=10, d=32, shapes=SHAPES, dtype=np.float32):
    rng = np.random.default_rng(seed)
    n = sum(h * w for h, w in shapes)
    lv = len(shapes)
    return dict(
        query=rng.normal(0, 1, (b, nq, d)).astype(dtype),
        ref_xy=rng.uniform(0, 1, (b, nq, lv, 2)).astype(np.float32),
        ref_wh=rng.uniform(0.05, 0.6, (b, nq, lv, 2)).astype(np.float32),
        memory=rng.normal(0, 1, (b, n, d)).astype(dtype),
        valid=rng.uniform(size=(b, n)) > 0.2,
    )


# ------------------------------------------------------------ parts
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_group_norm_equals_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(0, 3, (3, 6, 7, 32)) + 1).astype(np.float32)
    valid = np.zeros((3, 6, 7), bool)
    valid[0] = True
    valid[1, :4, :5] = True  # image 2: nothing valid (count clamps to 1)
    jx = jnp.asarray(x).astype(dtype)
    jm = jdd.MaskedGroupNorm(8)
    v = randomized(jm.init(jax.random.key(0), jx, jnp.asarray(valid)), 1)
    ref = np.asarray(jm.apply(v, jx, jnp.asarray(valid)).astype(jnp.float32))
    tm = port_module(tdd.MaskedGroupNorm(8, 32), v)
    out = tm(t(x).to(getattr(torch, dtype)), t(valid))
    assert out.dtype == getattr(torch, dtype)
    # bf16: one rounding of the same f32 value, at most an ulp apart.
    close(out.float(), ref, ATOL if dtype == "float32"
          else 2 ** -7 * np.abs(ref).max())


@pytest.mark.parametrize("d_model", [32, 256])
def test_sine_position_embedding_equals_jax(d_model):
    valid = np.zeros((2, 9, 11), bool)
    valid[0] = True
    valid[1, :5, :8] = True
    ref = np.asarray(jax.vmap(lambda m: jax_sine(m, d_model))(
        jnp.asarray(valid)))
    out = sine_position_embedding(t(valid), d_model)
    assert out.shape == ref.shape == (2, 9, 11, d_model)
    close(out, ref)


@pytest.mark.parametrize("box_ref", [False, True])
def test_ms_deform_attn_module_equals_jax(box_ref):
    x = attn_inputs(1)
    ref_wh = x["ref_wh"] if box_ref else None
    jm = jdd.MSDeformAttn(32, 4, 3, 2, jnp.float32, gather="mxu")
    args = (x["query"], x["ref_xy"], ref_wh, x["memory"], x["valid"])
    v = randomized(jm.init(jax.random.key(0), *args, SHAPES), 2)
    ref = np.asarray(jm.apply(v, *args, SHAPES))
    tm = port_module(tdd.MSDeformAttn(32, 4, 3, 2, torch.float32,
                                      gather="mxu"), v)
    out = tm(t(x["query"]), t(x["ref_xy"]),
             None if ref_wh is None else t(ref_wh), t(x["memory"]),
             t(x["valid"]), SHAPES)
    close(out, ref)
    assert np.abs(ref).std() > 0.1


def test_encoder_layer_equals_jax():
    x = attn_inputs(3)
    rng = np.random.default_rng(4)
    pos = rng.normal(0, 1, x["memory"].shape).astype(np.float32)
    enc_ref = rng.uniform(0, 1, (2, 64, 3, 2)).astype(np.float32)
    jm = jdd.DeformableEncoderLayer(32, 4, 3, 2, 64, 0.0, jnp.float32)
    args = (x["memory"], pos, enc_ref, x["valid"], SHAPES)
    v = randomized(jm.init(jax.random.key(0), *args, True), 5)
    ref = np.asarray(jm.apply(v, *args, True))
    tm = port_module(tdd.DeformableEncoderLayer(32, 4, 3, 2, 64,
                                                torch.float32), v)
    out = tm(*(t(a) for a in args[:4]), SHAPES)
    close(out, ref)


@pytest.mark.parametrize("box_ref", [False, True])
def test_decoder_layer_equals_jax(box_ref):
    x = attn_inputs(6)
    qpos = np.random.default_rng(7).normal(0, 1, x["query"].shape).astype(
        np.float32)
    ref_wh = x["ref_wh"] if box_ref else None
    jm = jdd.DeformableDecoderLayer(32, 4, 3, 2, 64, 0.0, jnp.float32)
    args = (x["query"], qpos, x["memory"], x["ref_xy"], ref_wh, x["valid"],
            SHAPES)
    v = randomized(jm.init(jax.random.key(0), *args, True), 8)
    ref = np.asarray(jm.apply(v, *args, True))
    tm = port_module(tdd.DeformableDecoderLayer(32, 4, 3, 2, 64,
                                                torch.float32), v)
    out = tm(*(None if a is None else t(a) for a in args[:6]), SHAPES)
    close(out, ref)


def test_bf16_modules_close_to_jax():
    """The bf16 MSDeformAttn and encoder layer at full width (d 256, 8
    heads, D 32, 4 levels x 4 points), against Flax's bf16. Both follow the
    same dtype flow (bf16 value and out projections, f32 offsets, weights
    and sampling, f32 LayerNorm output), but round at other places: Flax
    rounds a Dense's product to bf16 and then adds the bias in bf16, and
    XLA on the CPU may keep bf16 intermediates in f32. So outputs differ by
    about a bf16 ulp of their magnitude where a rounding goes the other
    way: tolerance ``2^-6`` of the largest output for the largest error
    and ``2^-9`` for the mean (measured: 0.0051 and 0.00062 of it for
    MSDeformAttn, 0.0045 and 0.00046 for the encoder layer)."""
    shapes = ((8, 10), (4, 5), (2, 3), (1, 2))
    x = attn_inputs(9, nq=12, d=256, shapes=shapes)
    pos = np.random.default_rng(10).normal(0, 1, x["memory"].shape).astype(
        np.float32)
    jbf = jnp.bfloat16
    jm = jdd.MSDeformAttn(256, 8, 4, 4, jbf)
    args = (jnp.asarray(x["query"], jbf), x["ref_xy"], None,
            jnp.asarray(x["memory"], jbf), x["valid"])
    v = randomized(jm.init(jax.random.key(0), *args, shapes), 11, std=0.05)
    ref = np.asarray(jm.apply(v, *args, shapes).astype(jnp.float32))
    tm = port_module(tdd.MSDeformAttn(256, 8, 4, 4, torch.bfloat16), v)
    out = tm(t(x["query"]).bfloat16(), t(x["ref_xy"]), None,
             t(x["memory"]).bfloat16(), t(x["valid"]), shapes).float()
    err = np.abs(out.numpy() - ref)
    scale = np.abs(ref).max()
    assert err.max() <= 2 ** -6 * scale and err.mean() <= 2 ** -9 * scale

    n = x["memory"].shape[1]
    enc_ref = np.random.default_rng(12).uniform(0, 1, (2, n, 4, 2)).astype(
        np.float32)
    je = jdd.DeformableEncoderLayer(256, 8, 4, 4, 1024, 0.0, jbf)
    eargs = (jnp.asarray(x["memory"], jbf), jnp.asarray(pos, jbf), enc_ref,
             x["valid"], shapes)
    ve = randomized(je.init(jax.random.key(0), *eargs, True), 13, std=0.05)
    ref = np.asarray(je.apply(ve, *eargs, True))
    te = port_module(tdd.DeformableEncoderLayer(256, 8, 4, 4, 1024,
                                                torch.bfloat16), ve)
    out = te(t(x["memory"]).bfloat16(), t(pos).bfloat16(), t(enc_ref),
             t(x["valid"]), shapes)
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    err = np.abs(out.numpy() - ref)
    scale = np.abs(ref).max()
    assert err.max() <= 2 ** -6 * scale and err.mean() <= 2 ** -9 * scale


# ------------------------------------------------------------ the model
def test_build_checks_and_unported_parts():
    cfg = tconfig.tiny_deformable_detr_config()
    model = build_model(cfg, device="cpu")
    assert isinstance(model, tdd.DeformableDETR)
    assert model.device == torch.device("cpu")
    dd = cfg.deformable_detr
    for field, value, match in (("num_heads", 3, "num_heads"),
                                ("num_queries", 4, "num_queries"),
                                ("num_levels", 2, "num_levels"),
                                ("d_model", 30, "divisible by 4")):
        with pytest.raises(ValueError, match=match):
            tdd.DeformableDETR(cfg.replace(deformable_detr=dataclasses.replace(
                dd, **{field: value})), device="cpu")
    with pytest.raises(ValueError, match="use_fpn"):
        tdd.DeformableDETR(cfg.replace(backbone=dataclasses.replace(
            cfg.backbone, use_fpn=True)), device="cpu")
    with pytest.raises(ValueError, match="rpn_only"):
        tdd.DeformableDETR(cfg.replace(rpn_only=True), device="cpu")
    # Head-shared sampling needs the patch gather, as in the JAX package.
    with pytest.raises(ValueError, match="patch"):
        tdd.DeformableDETR(cfg.replace(deformable_detr=dataclasses.replace(
            dd, shared_sampling_locations=True)), device="cpu")
    shared = tdd.DeformableDETR(cfg.replace(deformable_detr=dataclasses.replace(
        dd, sampling_gather="patch", shared_sampling_locations=True)),
        device="cpu")
    assert shared.core.enc0.deform_attn.sampling_offsets.weight.shape[0] == (
        dd.num_levels * dd.num_points * 2)
    # The loss is ported; in training mode with dropout it needs the
    # generator that draws the masks.
    dropping = tdd.DeformableDETR(cfg.replace(
        deformable_detr=dataclasses.replace(dd, dropout=0.1)), device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        dropping.loss({})


def test_init_draws_flax_initializers():
    cfg = tconfig.tiny_deformable_detr_config()
    core = build_model(cfg, device="cpu").init(seed=3).core
    attn = core.enc0.deform_attn
    assert (attn.sampling_offsets.weight == 0).all()
    assert (attn.attention_weights.weight == 0).all()
    bias = attn.sampling_offsets.bias.reshape(4, 4, 2, 2)
    assert torch.equal(bias[0, 0, 1], torch.tensor([2.0, 0.0]))
    assert torch.allclose(core.class_head0.bias,
                          torch.full((3,), -4.59511985), atol=1e-6)
    assert (core.bbox_head0.out.weight == 0).all()
    assert abs(core.query_embed.std().item() - 1) < 0.1
    assert (core.dec0.norm1.weight == 1).all()
    again = build_model(cfg, device="cpu").init(seed=3).core
    assert torch.equal(again.dec1.self_attn.query.weight,
                       core.dec1.self_attn.query.weight)
