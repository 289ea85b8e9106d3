"""The port's RoI poolers against the JAX package's same pooler, on c4
and with FPN, on the CPU (the rest of the options: ``test_torch_options.py``).

The routed poolers (``roi_align_gather``, ``roi_align_pallas``,
``roi_align_packed``) compute ``roi_align``'s value: their pooled features
equal tpudet's same pooler's within 1e-4 (``roi_align_pallas`` through
tpudet's gather pooler: its Pallas kernel in interpret mode takes minutes
for a few RoIs here) and the port's ``roi_align`` bit for bit (the same
kernel).
``crop_and_resize`` is TF's convention in plain PyTorch, f32 as the JAX
function returns it (with FPN each RoI at its FPN-paper level). Each
pooler's predict equals tpudet's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_faster_rcnn import (
    assert_same_detections,
    configs,
    pair,
)
from tests.test_torch_faster_rcnn_train import t
from tests.test_torch_options import ROUTED, predicts, same_weights, uint8_batch
from tpudet.models.faster_rcnn import DetectorCore as JaxCore

torch.set_num_threads(2)


def rois_for(rng, b=2, n=24, size=128):
    """Boxes of every scale (2..128 px, so every FPN level), a few past the
    canvas's edge."""
    wh = np.exp(rng.uniform(np.log(2), np.log(size), (b, n, 2)))
    xy = rng.uniform(-8, size - 4, (b, n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("fpn", [False, True], ids=["c4", "fpn"])
@pytest.mark.parametrize("pooler", ROUTED + ("crop_and_resize",))
def test_pooler_features_and_predict_equal_jax(pooler, fpn):
    groups = {"roi": {"pooler": pooler}}
    if fpn:
        groups["backbone"] = {"use_fpn": True}
    jcfg, tcfg = configs("tiny", **groups)
    if pooler == "roi_align_pallas":
        # tpudet's Pallas pooler runs in interpret mode on the CPU, minutes
        # for a handful of RoIs: it is held through tpudet's gather pooler,
        # to which tpudet's own test_pooler_backends_run holds it.
        jcfg = jcfg.replace(roi=dataclasses.replace(
            jcfg.roi, pooler="roi_align_gather"))
    jm, v, tm = pair(jcfg, tcfg, seed=6)
    rng = np.random.default_rng(3)
    images = rng.normal(0, 1, (2, 128, 128, 3)).astype(np.float32)
    rois = rois_for(rng)

    def jax_pool(v, images, rois):
        feats = jm.core.apply(v, images, method=JaxCore.features)
        return jm._pool_batch(feats, rois)

    ref = np.asarray(jax.jit(jax_pool)(v, images, rois))
    with torch.no_grad():
        feats = tm.core.features(t(images))
        pooled = tm._pool_batch(feats, t(rois))
    assert pooled.shape == ref.shape and pooled.shape[:4] == (2, 24, 7, 7)
    np.testing.assert_allclose(pooled.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert np.abs(ref).max() > 0.1
    if pooler in ROUTED:  # roi_align's kernel, bit for bit
        base = tcfg.replace(roi=dataclasses.replace(tcfg.roi,
                                                    pooler="roi_align"))
        with torch.no_grad():
            want = same_weights(tm, base)._pool_batch(feats, t(rois))
        assert torch.equal(pooled, want)
    else:
        assert pooled.dtype == torch.float32
    out, ref = predicts(jm, v, jcfg, tm, tcfg, uint8_batch())
    assert (ref["num_detections"] > 5).all()
    assert_same_detections(out, ref)
