"""DETR of the PyTorch port against ``tpudet``'s, on the CPU, at
``detr_tiny``: multi-head attention with Flax's key mask (f32, and bf16 at
full width), its scale filled on the device with the bits it had, the
encoder layer on a padded canvas and the decoder layer, the constructor's
refusals, ``DETRCore``'s per-layer logits and boxes, ``detr_set_loss``
per (layer, image) with its matches, ``loss`` and its gradients, without
``aux_loss``, dropout, ``predict``, the tiny learning check at tpudet's bar
(``tests/test_detr.py``: adam 1e-3, clip 0.1, 20 steps, the last loss under
0.6x the first) and the CLIs.

Weights: Flax's init (at 3 classes the softmax over 4 columns already puts
scores above ``score_thresh``); the modules' tests redraw every parameter
(``tests.test_torch_deformable_detr.randomized``).

Tolerances (f32): module outputs within 1e-5 (outputs of order 1, as
``tests/test_torch_deformable_detr.py``); the core's logits and boxes
within 1e-5 of their largest magnitude; matches exactly equal; the set
loss's sums and each loss term within 1e-5 relative; gradients within 1e-4
of their largest magnitude plus 1e-5 of their values plus 1e-6 of the
model's largest gradient; detections: valid masks and classes equal,
boxes within 1e-3 px plus 1e-4 relative, scores within 1e-5. bf16
attention at d 256: ``2^-6`` of the largest output for the largest error,
``2^-9`` for the mean (the rounding places differ, as in
``test_torch_deformable_detr.test_bf16_modules_close_to_jax``).
"""

import dataclasses
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_deformable_detr import port_module, randomized
from tests.test_torch_deformable_detr_train import train_batch
from tests.test_torch_retinanet import (
    assert_grads_equal,
    assert_same_detections,
    cli_train_eval_detect,
    predict_both,
    synthetic_batch,
    t,
    uint8_batch,
)
from tpudet import config as jconfig
from tpudet.models import DETR as JaxDETR
from tpudet.models import detr as jdetr
from tpudet.models.detr import DETRCore as JaxCore
from tpudet.train import losses as jax_losses
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models import detr as tdetr
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.train import losses as tlosses

torch.set_num_threads(2)
METRICS = {"loss", "class_ce_loss", "l1_box_loss", "giou_box_loss", "num_gt"}


def configs(**fields):
    return [c.replace(detr=dataclasses.replace(c.detr, **fields))
            for c in (jconfig.tiny_detr_config(), tconfig.tiny_detr_config())]


def pair(jcfg, tcfg, seed):
    jm = JaxDETR(jcfg)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.key(seed)))
    tm = build_model(tcfg, device="cpu")
    tm.core.load_state_dict(from_flax_variables(v))  # strict
    return jm, v, tm


def padded_tokens(seed, b=2, hf=5, wf=6, d=32):
    """Tokens, positional embeddings and the key mask of a padded canvas:
    image 0 fills it, image 1 covers 3x4 of its 5x6 cells."""
    rng = np.random.default_rng(seed)
    valid = np.zeros((b, hf, wf), bool)
    valid[0] = True
    valid[1, :3, :4] = True
    src = rng.normal(0, 1, (b, hf * wf, d)).astype(np.float32)
    pos = np.asarray(jax.vmap(lambda m: jdetr.sine_position_embedding(m, d))(
        jnp.asarray(valid))).reshape(b, hf * wf, d)
    return src, pos, valid.reshape(b, 1, 1, hf * wf)


# ------------------------------------------------------------ attention
def test_masked_attention_equals_flax():
    """Flax's attention with a ``[B, 1, 1, K]`` key mask; the masked keys'
    values and logits do not reach the output; an all-True mask is no
    mask."""
    src, pos, mask = padded_tokens(0)
    q = src + pos
    jm = fnn.MultiHeadDotProductAttention(num_heads=4, qkv_features=32)
    v = randomized(jm.init(jax.random.key(0), q, q, src, mask=mask), 1)
    ref = np.asarray(jm.apply(v, q, q, src, mask=mask))
    tm = port_module(tdetr.MultiHeadDotProductAttention(32, 4, torch.float32),
                     v)
    out = tm(t(q), t(q), t(src), mask=t(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    # Image 1's padded keys: new values there change nothing.
    keys, values = q.copy(), src.copy()
    keys[1][~mask[1, 0, 0]] += 5.0
    values[1][~mask[1, 0, 0]] -= 5.0
    again = tm(t(q), t(keys), t(values), mask=t(mask))
    assert torch.equal(again[1], out[1])
    full = np.ones_like(mask)
    assert torch.equal(tm(t(q), t(q), t(src), mask=t(full)),
                       tm(t(q), t(q), t(src)))


def test_masked_attention_bf16_close_to_flax():
    src, pos, mask = padded_tokens(2, d=256)
    q = (src + pos).astype(np.float32)
    jbf = jnp.bfloat16
    jm = fnn.MultiHeadDotProductAttention(num_heads=8, qkv_features=256,
                                          dtype=jbf)
    args = (jnp.asarray(q, jbf), jnp.asarray(q, jbf), jnp.asarray(src, jbf))
    v = randomized(jm.init(jax.random.key(0), *args, mask=mask), 3, std=0.05)
    ref = np.asarray(jm.apply(v, *args, mask=mask).astype(jnp.float32))
    tm = port_module(tdetr.MultiHeadDotProductAttention(256, 8,
                                                        torch.bfloat16), v)
    out = tm(t(q).bfloat16(), t(q).bfloat16(), t(src).bfloat16(),
             mask=t(mask)).float().numpy()
    err, scale = np.abs(out - ref), np.abs(ref).max()
    assert err.max() <= 2 ** -6 * scale and err.mean() <= 2 ** -9 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [4, 8, 32])
def test_scale_is_a_device_fill_with_the_same_bits(monkeypatch, dtype,
                                                   head_dim):
    """The query's ``1/sqrt(head_dim)``: ``sqrt`` in f32 rounded to the
    dtype, as before (a host tensor copied to the device per call), now a
    fill; no ``torch.tensor`` is made in the forward."""
    attn = tdetr.MultiHeadDotProductAttention(4 * head_dim, 4, dtype)
    old = torch.tensor(math.sqrt(head_dim), dtype=torch.float32).to(dtype)
    new = torch.full((), attn.root, dtype=dtype)
    assert torch.equal(old, new)
    jax_root = jnp.sqrt(head_dim).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                         else jnp.float32)
    assert float(new) == float(jax_root)

    def no_tensor(*args, **kw):
        raise AssertionError("torch.tensor in the attention's forward")

    x = torch.randn(2, 3, 4 * head_dim).to(dtype)
    monkeypatch.setattr(torch, "tensor", no_tensor)
    attn(x, x, x)


def test_encoder_layer_on_a_padded_canvas_equals_jax():
    src, pos, mask = padded_tokens(4)
    jm = jdetr.EncoderLayer(32, 4, 64, 0.0, jnp.float32)
    v = randomized(jm.init(jax.random.key(0), src, pos, mask, True), 5)
    ref = np.asarray(jm.apply(v, src, pos, mask, True))
    tm = port_module(tdetr.EncoderLayer(32, 4, 64, torch.float32), v)
    out = tm(t(src), t(pos), t(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_decoder_layer_equals_jax():
    memory, pos, mask = padded_tokens(6)
    rng = np.random.default_rng(7)
    tgt = rng.normal(0, 1, (2, 7, 32)).astype(np.float32)
    qpos = rng.normal(0, 1, (2, 7, 32)).astype(np.float32)
    jm = jdetr.DecoderLayer(32, 4, 64, 0.0, jnp.float32)
    args = (tgt, qpos, memory, pos, mask)
    v = randomized(jm.init(jax.random.key(0), *args, True), 8)
    ref = np.asarray(jm.apply(v, *args, True))
    tm = port_module(tdetr.DecoderLayer(32, 4, 64, torch.float32), v)
    out = tm(*(t(a) for a in args))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case,match", [
    ("rpn_only", "rpn_only"), ("fpn", "use_fpn=False"),
    ("d_model", "divisible by 4"), ("heads", "not divisible by num_heads"),
    ("queries", "num_queries")])
def test_constructor_refusals_as_jax(case, match):
    cfgs = []
    for cfg in (jconfig.tiny_detr_config(), tconfig.tiny_detr_config()):
        d = cfg.detr
        cfgs.append({
            "rpn_only": lambda: cfg.replace(rpn_only=True),
            "fpn": lambda: cfg.replace(backbone=dataclasses.replace(
                cfg.backbone, use_fpn=True)),
            "d_model": lambda: cfg.replace(detr=dataclasses.replace(
                d, d_model=30, num_heads=3)),
            "heads": lambda: cfg.replace(detr=dataclasses.replace(
                d, num_heads=3)),
            "queries": lambda: cfg.replace(detr=dataclasses.replace(
                d, num_queries=5)),
        }[case]())
    with pytest.raises(ValueError, match=match) as ref:
        JaxDETR(cfgs[0])
    with pytest.raises(ValueError, match=match) as port:
        build_model(cfgs[1], device="cpu")
    assert str(port.value) == str(ref.value)


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def run():
    jcfg, tcfg = configs()
    jm, v, tm = pair(jcfg, tcfg, seed=2)
    batch = train_batch(tcfg, seed=3)
    core = jax.jit(lambda v, im, hw: jm.core.apply(
        v, im, hw, method=JaxCore.forward))(v, batch["image"],
                                             batch["image_hw"])

    def loss(params):
        return jm.loss({**v, "params": params}, batch, jax.random.key(0))

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    return dict(jm=jm, v=v, tm=tm, jcfg=jcfg, tcfg=tcfg, batch=batch,
                core=[np.asarray(x) for x in core],
                metrics={k: float(x) for k, x in metrics.items()},
                grads=from_flax_variables({"params": grads}))


def test_core_equals_jax_per_layer(run):
    """Every decoder layer's logits ``[L, B, Q, C + 1]`` and boxes, on an
    image whose true extent is smaller than the canvas."""
    tm, batch = run["tm"], run["batch"]
    with torch.no_grad():
        out = tm.core(t(batch["image"]), t(batch["image_hw"]))
    for port, ref, what in zip(out, run["core"], ("logits", "boxes")):
        assert port.shape == ref.shape and port.dtype == torch.float32
        for layer in range(ref.shape[0]):
            np.testing.assert_allclose(
                port[layer].numpy(), ref[layer], rtol=0,
                atol=1e-5 * np.abs(ref[layer]).max(),
                err_msg=f"{what} layer {layer}")


def test_set_loss_and_matches_equal_jax(run):
    """``detr_set_loss`` on the core's outputs for every (layer, image),
    against tpudet's vmapped one; the port's matches equal tpudet's matcher
    on the port's costs."""
    import importlib

    from tpudet.ops import boxes as jbox
    from tpudet_torch.ops import hungarian as thung

    jhung = importlib.import_module("tpudet.ops.hungarian")
    logits, boxes = run["core"]
    batch, d = run["batch"], run["jcfg"].detr
    hw = batch["image_hw"]
    norm = np.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)[:, None]
    gt_n = np.asarray(jbox.xyxy_to_cxcywh(jnp.asarray(batch["gt_boxes"]))
                      ) / norm
    kw = dict(cost_class=d.cost_class, cost_bbox=d.cost_bbox,
              cost_giou=d.cost_giou, eos_coef=d.eos_coef)
    ref = jax.vmap(jax.vmap(lambda lg, bx, g, c, ok: jax_losses.detr_set_loss(
        lg, bx, g, c, ok, **kw)), in_axes=(0, 0, None, None, None))(
        logits, boxes, gt_n, batch["gt_classes"], batch["gt_valid"])
    layers = logits.shape[0]
    seen = []
    real = thung.hungarian_masked

    def recording(cost, valid):
        seen.append((cost, valid, real(cost, valid)))
        return seen[-1][2]

    tlosses.hungarian_masked = recording
    try:
        out = tlosses.detr_set_loss(
            t(logits), t(boxes), t(gt_n).float().expand(layers, -1, -1, -1),
            t(batch["gt_classes"]).expand(layers, -1, -1),
            t(batch["gt_valid"]).expand(layers, -1, -1), **kw)
    finally:
        tlosses.hungarian_masked = real
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    (cost, valid, match), = seen
    want = jax.vmap(jax.vmap(jhung.hungarian_masked))(cost.numpy(),
                                                      valid.numpy())
    np.testing.assert_array_equal(match.numpy(), np.asarray(want))
    assert float(out[4].sum()) == 2 * (3 + 5)


def test_loss_terms_and_gradients_equal_jax(run):
    tm, ref = run["tm"], run["metrics"]
    total, metrics = tm.loss({k: t(x) for k, x in run["batch"].items()})
    assert set(metrics) == set(ref) == METRICS
    for k in ref:
        assert float(metrics[k].detach()) == pytest.approx(ref[k], rel=1e-5), k
    assert ref["num_gt"] == 4.0 and ref["loss"] > 1.0
    total.backward()
    assert_grads_equal(tm, run["grads"])


def test_aux_loss_off_uses_the_last_layer_only(run):
    """Without ``aux_loss`` the total is the last layer's weighted loss, as
    JAX slices ``logits[-1:]``; and both packages agree on it."""
    jcfg, tcfg = configs(aux_loss=False)
    jm = JaxDETR(jcfg)
    _, ref = jax.jit(jm.loss)(run["v"], run["batch"], jax.random.key(0))
    model = build_model(tcfg, device="cpu")
    model.core.load_state_dict(run["tm"].core.state_dict())
    with torch.no_grad():
        total, last = model.loss({k: t(x) for k, x in run["batch"].items()})
    for k in METRICS:
        assert float(last[k]) == pytest.approx(float(ref[k]), rel=1e-5), k
    d = tcfg.detr
    assert float(total) == pytest.approx(
        d.loss_weight_class * float(last["class_ce_loss"])
        + d.loss_weight_bbox * float(last["l1_box_loss"])
        + d.loss_weight_giou * float(last["giou_box_loss"]), rel=1e-6)
    assert float(total) < run["metrics"]["loss"]


def test_train_mode_dropout_needs_a_generator_and_follows_it():
    _, tcfg = configs(dropout=0.1)
    model = build_model(tcfg, device="cpu").init(seed=1).train()
    batch = {k: t(x) for k, x in train_batch(tcfg, 3).items()}
    with pytest.raises(ValueError, match="torch.Generator"):
        model.loss(batch)
    with torch.no_grad():
        a, _ = model.loss(batch, torch.Generator().manual_seed(0))
        b, _ = model.loss(batch, torch.Generator().manual_seed(0))
        c, _ = model.loss(batch, torch.Generator().manual_seed(1))
        model.eval()
        d, _ = model.loss(batch, torch.Generator().manual_seed(0))
        e, _ = model.loss(batch)
    assert float(a) == float(b) != float(c)
    assert float(d) == float(e) != float(a)


def test_predict_equals_jax(run):
    out, ref = predict_both(run["jm"], run["v"], run["jcfg"], run["tm"],
                            run["tcfg"], uint8_batch(8))
    assert (ref["num_detections"] > 5).all()
    assert_same_detections(out, ref)


# --------------------------------------------------------------- learning
def test_tiny_learning_check():
    """tpudet's bar (tests/test_detr.py): adam 1e-3, no warmup, clip 0.1,
    weight decay 1e-4, 20 steps on one synthetic batch; the first loss
    under 30, the last under 0.6x the first."""
    from tpudet_torch.train.state import create_train_state
    from tpudet_torch.train.step import make_train_step

    cfg = tconfig.tiny_detr_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, optimizer="adam", learning_rate=1e-3, warmup_steps=0,
        grad_clip_norm=0.1, weight_decay=1e-4))
    model = build_model(cfg, device="cpu")
    state = create_train_state(model, cfg.train, seed=0, device="cpu")
    step = make_train_step(model, cfg, device="cpu")
    batch = synthetic_batch(cfg)
    losses = []
    for _ in range(20):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    first, last = losses[0], losses[-1]
    assert np.isfinite(losses).all() and first < 30.0
    assert last < 0.6 * first, (first, last)


def test_cli_train_eval_detect(tmp_path, capsys):
    _, boxes = cli_train_eval_detect(tmp_path, capsys, "detr_tiny",
                                     "class_ce_loss=")
    assert len(boxes) > 0
