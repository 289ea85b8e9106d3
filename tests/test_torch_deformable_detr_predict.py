"""Deformable DETR predict of the PyTorch port against ``tpudet``'s
``DeformableDETR.predict``, on the CPU, with weights carried over by
``from_flax_variables``; and the port's own canvas invariance.

Weights are Flax's init with the kernels that init leaves degenerate drawn
wider from a seed: the offset and attention-weight kernels (zero at init:
every query would sample the same directional probe, uniformly weighted),
the class heads (at the focal prior every sigmoid sits at 0.01, below
``score_thresh=0.05``: no detection) and the last box layer (zero: every
box would be its reference). The widths keep offsets of about a cell,
class logits of a few units and box deltas of a few tenths.

Tolerances (f32): boxes within 1e-3 px, scores within 1e-5 (measured: a
few 1e-5 px and ~1e-6). Two detections whose scores tie within that error
may trade places; every other slot must match in place.
"""

import dataclasses

import flax
import jax
import numpy as np
import pytest
import torch

from tpudet import config as jconfig
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.models import DeformableDETR as JaxDeformableDETR
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.train.step import make_eval_step

torch.set_num_threads(2)
BOX_ATOL = 1e-3
SCORE_ATOL = 1e-5


def configs(num_classes=3, **fields):
    """The tiny Deformable DETR config in both packages, ``fields``
    replacing entries of its ``deformable_detr`` group."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.tiny_deformable_detr_config(num_classes=num_classes)
        out.append(cfg.replace(deformable_detr=dataclasses.replace(
            cfg.deformable_detr, **fields)))
    return out


def widened(variables, seed, d_model, class_std=1.0):
    """Flax's init with the degenerate kernels drawn wider (module doc)."""
    rng = np.random.default_rng(seed)
    unit = (32.0 / d_model) ** 0.5  # the same logit scale at any width
    std = {"sampling_offsets": 0.1, "attention_weights": 0.1,
           "class_head": class_std, "bbox_out": 0.1}
    v = flax.core.unfreeze(jax.tree_util.tree_map(np.asarray, variables))
    flat = flax.traverse_util.flatten_dict(v["params"])
    for key, leaf in flat.items():
        if key[-1] != "kernel":
            continue
        name = ("bbox_out" if key[0].startswith("bbox_head") and key[-2] == "out"
                else "class_head" if key[0].startswith("class_head")
                else key[-2])
        if name in std:
            flat[key] = rng.normal(0, std[name] * unit, leaf.shape).astype(
                np.float32)
    v["params"] = flax.traverse_util.unflatten_dict(flat)
    return v


def pair(jcfg, tcfg, seed=0, class_std=1.0):
    jm = JaxDeformableDETR(jcfg)
    v = widened(jax.jit(jm.init)(jax.random.key(seed)), seed,
                jcfg.deformable_detr.d_model, class_std)
    tm = build_model(tcfg, device="cpu")
    tm.core.load_state_dict(from_flax_variables(v))  # strict: every name maps
    return jm, v, tm


def assert_same_detections(port, ref):
    np.testing.assert_array_equal(port["valid"], ref["valid"])
    np.testing.assert_array_equal(port["num_detections"],
                                  ref["num_detections"])
    for b in range(ref["valid"].shape[0]):
        n = int(ref["num_detections"][b])
        free = list(range(n))
        for i in range(n):
            match = [k for k in free
                     if port["classes"][b, k] == ref["classes"][b, i]
                     and abs(port["scores"][b, k] - ref["scores"][b, i])
                     < SCORE_ATOL
                     and np.abs(port["boxes"][b, k] - ref["boxes"][b, i]).max()
                     < BOX_ATOL]
            assert match, f"detection {i} of image {b} has no counterpart"
            k = min(match, key=lambda m: abs(m - i))
            assert k == i or abs(ref["scores"][b, k] - ref["scores"][b, i]) \
                < SCORE_ATOL
            free.remove(k)
        assert (port["scores"][b, n:] == 0).all()
        assert (port["classes"][b, n:] == 0).all()


def uint8_batch(seed, b=2, h=128, w=128):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
            "image_hw": np.array([[h, w], [h * 0.75, w * 0.875]],
                                 np.float32)[:b]}


def predict_both(jm, v, jcfg, tm, tcfg, batch):
    ref = jax.jit(lambda v, bt: jm.predict(v, jax_preprocess(jcfg, bt)))(
        v, batch)
    ref = {k: np.asarray(x) for k, x in ref.items()}
    out = {k: x.numpy() for k, x in make_eval_step(tm, tcfg)(batch).items()}
    assert set(out) == set(ref)
    return out, ref


@pytest.mark.parametrize("refine", [False, True])
def test_tiny_predict_equals_jax(refine):
    """make_eval_step (uint8 canvases, fused preprocess) against the JAX
    predict: 2+2 layers of width 32, 4 heads (D = 8), 4 levels x 2 points,
    with and without iterative box refinement."""
    jcfg, tcfg = configs(with_box_refine=refine)
    jm, v, tm = pair(jcfg, tcfg, seed=1)
    out, ref = predict_both(jm, v, jcfg, tm, tcfg, uint8_batch(2))
    assert (ref["num_detections"] > 5).all()
    assert_same_detections(out, ref)


def test_full_width_transformer_predict_equals_jax():
    """The preset's transformer widths (d 256, 8 heads so D = 32, FFN 1024,
    4 levels x 4 points, 300 queries, 80 classes, box refinement) at 1+1
    layers on the tiny backbone and a 128-px canvas. Class kernels at 0.3
    of the tiny test's width: the top 100 of 24,000 (query, class) scores
    then lie mid-range instead of rounding to 1.0 in f32."""
    jcfg, tcfg = configs(d_model=256, num_heads=8, enc_layers=1,
                         dec_layers=1, ffn_dim=1024, num_queries=300,
                         num_points=4, max_detections=100,
                         with_box_refine=True, num_classes=80)
    jm, v, tm = pair(jcfg, tcfg, seed=3, class_std=0.3)
    out, ref = predict_both(jm, v, jcfg, tm, tcfg, uint8_batch(4))
    assert ref["boxes"].shape == (2, 100, 4)
    assert (ref["num_detections"] > 20).all()
    assert ref["scores"][:, -1].max() < 0.99
    assert_same_detections(out, ref)


def test_canvas_invariance():
    """The same 96x96 image on a 128x128 and a 160x192 canvas gives the
    same detections: positional embeddings over the valid extent, valid
    ratios scaling every reference, padded tokens' values zeroed and the
    extra level's (1, 1) padding keep the bucket out of every sampled
    feature. FrozenBN backbone, as in the JAX package's test (GroupNorm's
    statistics see the padding)."""
    cfg = tconfig.tiny_deformable_detr_config()
    cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                   norm="frozen_bn"))
    model = build_model(cfg, device="cpu").init(seed=4)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in model.core.named_parameters():
            if name.endswith(("sampling_offsets.weight",
                              "attention_weights.weight", "out.weight")) \
                    or name.startswith("class_head"):
                p.normal_(0, 0.3, generator=gen)
    img = torch.rand(96, 96, 3, generator=gen)
    outs = []
    for h, w in ((128, 128), (160, 192)):
        canvas = torch.zeros(1, h, w, 3)
        canvas[0, :96, :96] = img
        outs.append(model.predict({"image": canvas,
                                   "image_hw": torch.tensor([[96.0, 96.0]])}))
    a, b = outs
    assert int(a["num_detections"][0]) > 5
    torch.testing.assert_close(a["boxes"], b["boxes"], rtol=0, atol=1e-3)
    torch.testing.assert_close(a["scores"], b["scores"], rtol=0, atol=1e-5)
    assert torch.equal(a["classes"], b["classes"])
