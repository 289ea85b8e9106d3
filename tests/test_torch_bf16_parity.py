"""Whole bf16 predicts of the PyTorch port against ``tpudet``'s bf16
predicts, on the CPU, for the three inference presets cut to tiny size:
``tiny_test_config`` (single-level C4), the same with ``use_fpn=True``, and
``deformable_detr_tiny``, each with ``backbone.dtype="bfloat16"``. Weights
come from Flax and go through ``from_flax_variables``; inputs are uint8
canvases from a seed.

The two frameworks round to bf16 at the same places (every convolution and
GEMM computes in bf16 over f32 parameters) but accumulate inside each one
in their own order, so a value's two roundings may land an ulp apart
(``2^-8`` relative) and the ulps add up with depth. Selections (top-k of
the proposals, NMS, the detections' top-k) then flip where two scores tie
within that error. So the stages before a selection are held to a
tolerance, on the same inputs, and the selections are held by counting
flips:

* every float stage (features, RPN logits and deltas, the second stage's
  pooled features and head outputs on tpudet's own proposals; Deformable
  DETR's last-layer class logits and boxes) within ``STAGE_TOL`` of the
  stage's largest magnitude;
* detections: the same number per image; a tpudet detection is matched by
  a port detection of the same class with its score within ``SCORE_TOL``
  and its box within ``BOX_TOL`` pixels; at most ``FLIP_SHARE`` of them
  may go unmatched (a near-tie resolved the other way).

Each tolerance sits above the measured worst case over these presets by
a margin of about 2-6x, for other CPUs' bf16 kernels (the constants say
what was measured). No difference beyond bf16 rounding was found.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_deformable_detr_predict import pair as detr_pair
from tests.test_torch_faster_rcnn import configs, pair
from tpudet import config as jconfig
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.models.deformable_detr import DeformableDETRCore
from tpudet.models.faster_rcnn import DetectorCore as JaxCore
from tpudet_torch import config as tconfig
from tpudet_torch.data.preprocess import device_preprocess
from tpudet_torch.train.step import make_eval_step

torch.set_num_threads(2)

# Measured worst stage error over the three presets: 1.12% of the largest
# magnitude (the C4 head's class logits; 0.29-1.09% elsewhere).
STAGE_TOL = 2 ** -5
# Measured on matched detections: scores within 0.011 (Deformable DETR's
# sigmoids of logits up to 16), boxes within 0.17 px; 2 of 20 detections
# of an image flipped at most (FPN), none in Deformable DETR. Proposals:
# at most 2 of 64 without a counterpart within 1 px.
SCORE_TOL = 2 ** -5
BOX_TOL = 1.0
FLIP_SHARE = 0.2


def faster_rcnn_case(use_fpn):
    jcfg, tcfg = configs("tiny", backbone=dict(dtype="bfloat16",
                                               use_fpn=use_fpn))
    jm, v, tm = pair(jcfg, tcfg, seed=6)

    def stages(v, batch):
        batch = jax_preprocess(jcfg, batch)
        images = batch["image"]
        feats = jm.core.apply(v, images, method=JaxCore.features)
        logits, deltas = jm.core.apply(v, feats, method=JaxCore.rpn)
        boxes, _, valid = jm.proposals(logits, deltas, batch["image_hw"],
                                       training=False,
                                       canvas_hw=images.shape[1:3])
        b, r = boxes.shape[:2]
        pooled = jm._pool_batch(feats, boxes)
        cls, box_deltas = jm.core.apply(
            v, pooled.reshape((b * r,) + pooled.shape[2:]),
            method=JaxCore.roi_head)
        return ({"rpn logits": logits, "rpn deltas": deltas, "pooled": pooled,
                 "class logits": cls, "box deltas": box_deltas,
                 **{f"features {k}": f for k, f in feats.items()}},
                {"boxes": boxes, "valid": valid},
                jm.predict(v, batch))

    def port_stages(batch, proposals):
        with torch.inference_mode():
            batch = device_preprocess(tcfg, batch)
            feats = tm.core.features(batch["image"])
            logits, deltas = tm.core.rpn(feats)
            boxes, _, valid = tm.proposals(logits, deltas, batch["image_hw"],
                                           canvas_hw=(128, 128))
            # The second stage on tpudet's proposals: the same RoIs.
            pooled = tm._pool_batch(feats, proposals)
            cls, box_deltas = tm.core.roi_head(
                pooled.reshape((-1,) + pooled.shape[2:]))
        return ({"rpn logits": logits, "rpn deltas": deltas, "pooled": pooled,
                 "class logits": cls, "box deltas": box_deltas,
                 **{f"features {k}": f.permute(0, 2, 3, 1)
                    for k, f in feats.items()}},
                {"boxes": boxes, "valid": valid})

    return jcfg, tcfg, v, tm, stages, port_stages


def deformable_case():
    jcfg, tcfg = (dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="bfloat16"))
        for cfg in (jconfig.tiny_deformable_detr_config(),
                    tconfig.tiny_deformable_detr_config()))
    jm, v, tm = detr_pair(jcfg, tcfg, seed=1)

    def stages(v, batch):
        batch = jax_preprocess(jcfg, batch)
        logits, boxes = jm.core.apply(v, batch["image"], batch["image_hw"],
                                      deterministic=True,
                                      method=DeformableDETRCore.forward)
        return ({"class logits": logits[-1], "boxes": boxes[-1]}, {},
                jm.predict(v, batch))

    def port_stages(batch, proposals):
        with torch.inference_mode():
            batch = device_preprocess(tcfg, batch)
            logits, boxes = tm.core(batch["image"], batch["image_hw"])
        return {"class logits": logits[-1], "boxes": boxes[-1]}, {}

    return jcfg, tcfg, v, tm, stages, port_stages


def as_numpy(tree):
    return {k: np.asarray(x, np.float32) if np.asarray(x).dtype.kind == "f"
            or str(np.asarray(x).dtype) == "bfloat16" else np.asarray(x)
            for k, x in tree.items()}


def run_case(name):
    """Both packages' stages, proposals and detections on one batch."""
    case = (deformable_case() if name == "deformable_detr"
            else faster_rcnn_case(name == "fpn"))
    jcfg, tcfg, v, tm, stages, port_stages = case
    rng = np.random.default_rng(7)
    batch = {"image": rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8),
             "image_hw": np.array([[128, 128], [96, 128]], np.float32)}
    ref_stages, ref_props, ref_dets = (as_numpy(x) for x in
                                       jax.jit(stages)(v, batch))
    tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}
    port, props = port_stages(tbatch, torch.tensor(ref_props["boxes"])
                              if ref_props else None)
    dets = make_eval_step(tm, tcfg)(batch)
    return {"stages": ({k: x.float().numpy() for k, x in port.items()},
                       ref_stages),
            "proposals": ({k: x.numpy() for k, x in props.items()},
                          ref_props),
            "detections": ({k: x.numpy() for k, x in dets.items()}, ref_dets)}


@pytest.fixture(scope="module", params=["c4", "fpn", "deformable_detr"])
def runs(request):
    return run_case(request.param)


def test_bf16_stages_within_bf16_roundings(runs):
    port, ref = runs["stages"]
    assert set(port) == set(ref)
    for name, r in ref.items():
        scale = float(np.abs(r).max())
        err = float(np.abs(port[name] - r).max())
        assert scale > 0 and err <= STAGE_TOL * scale, (
            f"{name}: bf16 port differs from tpudet by {err:.4g}, "
            f"{err / scale:.3%} of the largest magnitude {scale:.4g}")


def matched(port, ref, b):
    """(matched, total) detections of image b: each of tpudet's valid
    detections against an unused port detection of the same class within
    SCORE_TOL and BOX_TOL."""
    free = set(np.flatnonzero(port["valid"][b]))
    hits, want = 0, np.flatnonzero(ref["valid"][b])
    for i in want:
        match = [k for k in free
                 if port["classes"][b, k] == ref["classes"][b, i]
                 and abs(port["scores"][b, k] - ref["scores"][b, i]) <= SCORE_TOL
                 and np.abs(port["boxes"][b, k] - ref["boxes"][b, i]).max()
                 <= BOX_TOL]
        if match:
            free.remove(min(match, key=lambda k: abs(k - i)))
            hits += 1
    return hits, len(want)


def test_bf16_detections_agree_up_to_near_tie_flips(runs):
    port, ref = runs["detections"]
    np.testing.assert_array_equal(port["num_detections"],
                                  ref["num_detections"])
    assert (ref["num_detections"] > 5).all()
    for b in range(ref["valid"].shape[0]):
        hits, total = matched(port, ref, b)
        assert total - hits <= FLIP_SHARE * total, (
            f"image {b}: {total - hits} of {total} bf16 detections flipped")
    port, ref = runs["proposals"]
    if ref:  # the RPN's top-k and NMS: near-tie flips only
        np.testing.assert_array_equal(port["valid"].sum(1),
                                      ref["valid"].sum(1))
        for b in range(ref["valid"].shape[0]):
            got = port["boxes"][b][port["valid"][b]]
            want = ref["boxes"][b][ref["valid"][b]]
            gap = np.abs(want[:, None] - got[None]).max(-1).min(1)
            assert (gap > BOX_TOL).sum() <= FLIP_SHARE * len(want), (
                f"image {b}: {(gap > BOX_TOL).sum()} of {len(want)} bf16 "
                "proposals have no counterpart")
