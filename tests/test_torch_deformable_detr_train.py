"""Deformable DETR training of the PyTorch port against ``tpudet``'s, on the
CPU: ``DeformableDETR.loss`` and the gradient of every parameter, with
weights carried over by ``from_flax_variables``; and the three training
faults the inference port had (box refinement leaking gradient, no
``freeze_stem``, no dropout).

Weights are ``test_torch_deformable_detr_predict.widened``'s: Flax's init
with the degenerate kernels drawn wider. Dropout is 0 (the tiny config's),
so both packages compute the same function; the masks of the two
frameworks' generators cannot be equal.

Tolerances (f32): the loss terms within ``1e-5`` relative; each
parameter's gradient within ``1e-4`` of its largest magnitude plus ``1e-5``
of its own values (the two frameworks sum convolutions, dense layers and
the focal grid in other orders), plus ``1e-6`` of the model's largest
gradient: a gradient that is zero in exact arithmetic (a bias that the
next normalization removes, the self-attention key biases that a softmax
ignores) is rounding noise on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_deformable_detr_predict import configs, widened
from tpudet.models import DeformableDETR as JaxDeformableDETR
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models import deformable_detr as tdd
from tpudet_torch.models import detr as tdetr
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.models.layers import dropout
from tpudet_torch.models.resnet import ResNet

torch.set_num_threads(2)
METRICS = ("loss", "focal_cls_loss", "l1_box_loss", "giou_box_loss", "num_gt")


def train_batch(cfg, seed=0, b=2):
    """Normalized images (noise with the boxes painted in), 3 and 5
    ground-truth boxes padded to ``max_gt_boxes``, the second image with a
    smaller true extent than the canvas."""
    rng = np.random.default_rng(seed)
    h = w = cfg.data.canvas_height
    g = cfg.data.max_gt_boxes
    image = rng.normal(0, 1, (b, h, w, 3)).astype(np.float32)
    hw = np.array([[h, w], [h * 0.75, w * 0.875]], np.float32)[:b]
    gt = np.zeros((b, g, 4), np.float32)
    classes = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i, k in enumerate((3, 5)[:b]):
        size = rng.uniform(0.15, 0.5, (k, 2)) * hw[i, ::-1]
        x1y1 = rng.uniform(0, 1, (k, 2)) * (hw[i, ::-1] - size)
        gt[i, :k] = np.concatenate([x1y1, x1y1 + size], -1)
        classes[i, :k] = rng.integers(1, cfg.data.num_classes + 1, k)
        valid[i, :k] = True
        for (x1, y1, x2, y2), c in zip(gt[i, :k].astype(int), classes[i, :k]):
            image[i, y1:y2, x1:x2] += c
    return {"image": image, "image_hw": hw, "gt_boxes": gt,
            "gt_classes": classes, "gt_valid": valid}


@pytest.fixture(scope="module", params=[False, True], ids=["points", "refine"])
def loss_pair(request):
    """The JAX loss, metrics and gradient tree, and the port's model with
    the same weights, for one refinement setting."""
    jcfg, tcfg = configs(with_box_refine=request.param)
    jm = JaxDeformableDETR(jcfg)
    v = widened(jax.jit(jm.init)(jax.random.key(4)), 4,
                jcfg.deformable_detr.d_model)
    batch = train_batch(tcfg)

    def loss(params):
        return jm.loss({"params": params}, batch, jax.random.key(0))

    (total, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    tm = build_model(tcfg, device="cpu")
    tm.core.load_state_dict(from_flax_variables(v))
    return tm, batch, ({k: float(x) for k, x in metrics.items()},
                       from_flax_variables({"params": grads}))


def test_loss_and_gradients_equal_jax(loss_pair):
    tm, batch, (ref_metrics, ref_grads) = loss_pair
    total, metrics = tm.loss({k: torch.from_numpy(x) for k, x in batch.items()})
    assert set(metrics) == set(METRICS)
    for k in METRICS:
        assert float(metrics[k].detach()) == pytest.approx(ref_metrics[k],
                                                           rel=1e-5), k
    assert ref_metrics["num_gt"] == 4.0 and ref_metrics["loss"] > 1.0
    total.backward()
    names = [n for n, _ in tm.core.named_parameters()]
    assert set(names) == set(ref_grads)
    floor = 1e-6 * max(float(g.abs().max()) for g in ref_grads.values())
    for name, p in tm.core.named_parameters():
        want = ref_grads[name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-4 * np.abs(want).max() + floor,
                                   err_msg=name)


def test_aux_loss_off_uses_the_last_layer_only():
    """Without ``aux_loss`` the total is the last decoder layer's weighted
    loss, as JAX slices ``logits[-1:]``."""
    _, tcfg = configs()
    model = build_model(tcfg, device="cpu").init(seed=2)
    batch = {k: torch.from_numpy(x) for k, x in train_batch(tcfg, 3).items()}
    with torch.no_grad():
        _, with_aux = model.loss(batch)
        model.cfg = tcfg.replace(deformable_detr=dataclasses.replace(
            tcfg.deformable_detr, aux_loss=False))
        total, last = model.loss(batch)
    d = tcfg.deformable_detr
    for k in ("focal_cls_loss", "l1_box_loss", "giou_box_loss"):
        assert float(last[k]) == pytest.approx(float(with_aux[k]), rel=1e-6)
    assert float(total) == pytest.approx(
        d.loss_weight_class * float(last["focal_cls_loss"])
        + d.loss_weight_bbox * float(last["l1_box_loss"])
        + d.loss_weight_giou * float(last["giou_box_loss"]), rel=1e-6)
    assert float(total) < float(with_aux["loss"])


# ---------------------------------------------------------------- repairs
def test_box_refinement_detaches_the_previous_layers_boxes():
    """Under ``with_box_refine`` layer 2 refines around layer 1's boxes
    without backpropagating into them (JAX's ``stop_gradient``): layer 2's
    boxes give layer 1's box head no gradient."""
    _, tcfg = configs(with_box_refine=True)
    model = build_model(tcfg, device="cpu").init(seed=1)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.core.bbox_head0.parameters():
            p.normal_(0, 0.1, generator=gen)
    batch = train_batch(tcfg)
    _, boxes = model.core(torch.from_numpy(batch["image"]),
                          torch.from_numpy(batch["image_hw"]))
    boxes[1].sum().backward()
    for name, p in model.core.bbox_head0.named_parameters():
        assert p.grad is None or not p.grad.any(), name
    assert model.core.bbox_head1.out.weight.grad.abs().max() > 0


@pytest.mark.parametrize("freeze", [True, False])
def test_freeze_stem_stops_the_gradient_after_c2(freeze):
    """``BackboneConfig.freeze_stem`` (JAX's default True) detaches the
    ResNet's c2: the stem and stage c2 get no gradient, c3 on do."""
    assert tconfig.BackboneConfig().freeze_stem is True
    net = ResNet(blocks=(1, 1, 1, 1), freeze_stem=freeze)
    gen = torch.Generator().manual_seed(0)
    for m in net.modules():
        if hasattr(m, "reset_parameters") and m is not net:
            m.reset_parameters(gen)
    feats = net(torch.randn(1, 3, 64, 64, generator=gen))
    feats["c5"].sum().backward()
    for name in ("stem_conv.weight", "stage2_block0.conv1.weight"):
        grad = dict(net.named_parameters())[name].grad
        assert (grad is None) == freeze, name
    assert net.stage3_block0.conv1.weight.grad.abs().max() > 0
    assert not feats["c2"].requires_grad or not freeze


def test_dropout_keeps_one_minus_rate_and_scales_them():
    """Flax's ``nn.Dropout``: each entry kept with probability 1 - rate and
    divided by 1 - rate; no generator, no dropout; the mask follows the
    generator's seed alone."""
    x = torch.full((200_000,), 3.0)
    out = dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.003
    assert torch.equal(out[kept], x[kept] / 0.9)
    again = dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    assert torch.equal(dropout(x, 0.1, None), x)
    assert not dropout(x, 1.0, torch.Generator()).any()


def test_attention_dropout_is_broadcast_over_images_and_heads():
    """The self-attention drops probabilities with one ``[q, k]`` mask for
    every image and head (Flax's ``broadcast_dropout``), scaled by
    ``1 / keep_prob``."""
    attn = tdetr.MultiHeadDotProductAttention(16, 4, torch.float32,
                                              dropout_rate=0.5)
    gen = torch.Generator().manual_seed(0)
    for m in attn.modules():
        if m is not attn:
            m.reset_parameters(gen)
    x = torch.randn(1, 6, 16, generator=gen).expand(3, -1, -1)
    out = attn(x, x, x, torch.Generator().manual_seed(1))
    assert torch.equal(out[0], out[1]) and torch.equal(out[1], out[2])
    # The same function with the mask drawn by hand from the same seed.
    keep = torch.rand((1, 1, 6, 6), generator=torch.Generator().manual_seed(1))
    q, k, v = (lin(x).reshape(3, 6, 4, 4)
               for lin in (attn.query, attn.key, attn.value))
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q / 2.0, k), -1)
    probs = probs * (keep < 0.5).float() / 0.5
    want = attn.out(torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(3, 6, 16))
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    assert 0 < int((keep < 0.5).sum()) < 36
    assert not torch.allclose(out, attn(x, x, x))


def test_dropout_runs_at_every_flax_site(monkeypatch):
    """One train-mode loss of the tiny model with dropout 0.1 applies it
    after every attention and FFN branch and inside every FFN (3 sites per
    encoder layer, 4 per decoder layer), and to the decoder
    self-attention's probabilities."""
    _, tcfg = configs(dropout=0.1)
    model = build_model(tcfg, device="cpu").init(seed=0)
    calls = []

    def counting(x, rate, generator, tp=None):
        calls.append((rate, generator is not None))
        return dropout(x, rate, generator, tp)

    monkeypatch.setattr(tdd, "dropout", counting)
    monkeypatch.setattr(tdetr, "dropout", counting)
    probs = []
    original = torch.rand

    def rand(*shape, **kw):
        probs.append(shape[0] if len(shape) == 1 else shape)
        return original(*shape, **kw)

    monkeypatch.setattr(tdetr.torch, "rand", rand)
    batch = {k: torch.from_numpy(x) for k, x in train_batch(tcfg).items()}
    model.loss(batch, torch.Generator().manual_seed(0))
    d = tcfg.deformable_detr
    assert calls == [(0.1, True)] * (3 * d.enc_layers + 4 * d.dec_layers)
    q = d.num_queries
    assert [p for p in probs if p[:2] == (1, 1)] == [(1, 1, q, q)] * d.dec_layers


def test_train_mode_loss_needs_a_generator_and_follows_it():
    _, tcfg = configs(dropout=0.1)
    model = build_model(tcfg, device="cpu").init(seed=0)
    batch = {k: torch.from_numpy(x) for k, x in train_batch(tcfg).items()}
    with pytest.raises(ValueError, match="Generator"):
        model.loss(batch)
    with torch.no_grad():
        a, _ = model.loss(batch, torch.Generator().manual_seed(5))
        b, _ = model.loss(batch, torch.Generator().manual_seed(5))
        c, _ = model.loss(batch, torch.Generator().manual_seed(6))
        model.eval()
        e1, _ = model.loss(batch)
        e2, _ = model.loss(batch, torch.Generator().manual_seed(5))
    assert float(a) == float(b) != float(c)
    assert float(e1) == float(e2) != float(a)
