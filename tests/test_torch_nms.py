"""NMS of the PyTorch port against the JAX package.

The same numpy inputs go to ``tpudet.ops.nms.nms`` (the jnp reference), to
``tpudet.kernels.nms.nms_pallas`` in interpret mode, and to the port's plain
versions on the CPU. Selection is discrete, so indices and valid masks must
be exactly equal: no tolerance.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpudet import kernels as jk
from tpudet.kernels.nms import nms_pallas
from tpudet.ops import nms as jnms
from tpudet_torch import kernels as tk
from tpudet_torch.kernels import nms as tk_nms
from tpudet_torch.ops import nms as tnms

torch.set_num_threads(2)


def scene(seed, n, extent=200.0, size=(8.0, 60.0)):
    """Random overlapping boxes and scores from a numpy seed."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, (n, 2))
    wh = rng.uniform(*size, (n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    return boxes, scores


def jax_nms(boxes, scores, thr, k, **kw):
    idx, valid = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), thr, k,
                          **{a: (jnp.asarray(b) if isinstance(b, np.ndarray)
                                 else b) for a, b in kw.items()})
    return np.asarray(idx), np.asarray(valid)


def pallas_nms(boxes, scores, thr, k, **kw):
    kw = {a: (jnp.asarray(b) if isinstance(b, np.ndarray) else b)
          for a, b in kw.items()}
    idx, valid = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), thr, k,
                            interpret=True, **kw)
    return np.asarray(idx), np.asarray(valid)


def port(fn, boxes, scores, thr, k, **kw):
    kw = {a: (torch.from_numpy(b) if isinstance(b, np.ndarray) else b)
          for a, b in kw.items()}
    idx, valid = fn(torch.from_numpy(boxes), torch.from_numpy(scores), thr, k,
                    **kw)
    return idx.numpy(), valid.numpy()


def assert_same(a, b):
    np.testing.assert_array_equal(a[1], b[1])  # valid masks
    np.testing.assert_array_equal(a[0], b[0])  # indices, invalid slots too


@pytest.mark.parametrize("thr", [0.5, 0.7])
@pytest.mark.parametrize("seed", [0, 1])
def test_nms_random_scene_equals_jax_and_pallas(seed, thr):
    boxes, scores = scene(seed, 300)
    ref = jax_nms(boxes, scores, thr, 100)
    assert_same(port(tnms.nms, boxes, scores, thr, 100), ref)
    assert_same(port(tk.nms_dispatch, boxes, scores, thr, 100), ref)
    assert_same(pallas_nms(boxes, scores, thr, 100), ref)


def test_nms_presorted_equals_jax_and_pallas():
    boxes, scores = scene(2, 256)
    order = np.argsort(-scores, kind="stable")
    boxes, scores = boxes[order], scores[order]
    mask = np.random.default_rng(3).uniform(size=256) > 0.2
    ref = jax_nms(boxes, scores, 0.7, 64, valid_mask=mask)
    assert_same(port(tk.nms_dispatch, boxes, scores, 0.7, 64, valid_mask=mask,
                     presorted=True), ref)
    assert_same(pallas_nms(boxes, scores, 0.7, 64, valid_mask=mask,
                           presorted=True), ref)


def test_nms_valid_mask_and_score_threshold():
    boxes, scores = scene(4, 200)
    mask = np.random.default_rng(5).uniform(size=200) > 0.3
    kw = dict(valid_mask=mask, score_threshold=0.4)
    ref = jax_nms(boxes, scores, 0.5, 50, **kw)
    assert_same(port(tnms.nms, boxes, scores, 0.5, 50, **kw), ref)
    assert_same(port(tk.nms_dispatch, boxes, scores, 0.5, 50, **kw), ref)
    assert_same(pallas_nms(boxes, scores, 0.5, 50, **kw), ref)


def test_nms_identical_boxes_and_tied_scores():
    # Ten copies of one box, four tied scores: ties go to the lower index.
    boxes = np.tile(np.array([[10, 10, 50, 50]], np.float32), (10, 1))
    boxes[5:] += np.float32(100.0)
    scores = np.array([0.5, 0.9, 0.9, 0.1, 0.9, 0.3, 0.3, 0.3, 0.8, 0.3],
                      np.float32)
    ref = jax_nms(boxes, scores, 0.5, 6)
    assert_same(port(tnms.nms, boxes, scores, 0.5, 6), ref)
    assert_same(port(tk.nms_dispatch, boxes, scores, 0.5, 6), ref)
    assert_same(pallas_nms(boxes, scores, 0.5, 6), ref)


def test_nms_all_masked_and_nan_score():
    boxes, scores = scene(6, 64)
    none = np.zeros(64, bool)
    ref = jax_nms(boxes, scores, 0.5, 10, valid_mask=none)
    assert not ref[1].any()
    assert_same(port(tk.nms_dispatch, boxes, scores, 0.5, 10, valid_mask=none),
                ref)
    scores[[3, 17]] = np.nan
    ref = jax_nms(boxes, scores, 0.5, 40)
    assert_same(port(tnms.nms, boxes, scores, 0.5, 40), ref)
    assert_same(port(tk.nms_dispatch, boxes, scores, 0.5, 40), ref)
    assert_same(pallas_nms(boxes, scores, 0.5, 40), ref)


def test_nms_max_outputs_above_n():
    boxes, scores = scene(7, 20, extent=400.0)
    ref = jax_nms(boxes, scores, 0.5, 64)
    assert ref[0].shape == (64,)
    assert_same(port(tnms.nms, boxes, scores, 0.5, 64), ref)
    assert_same(port(tk.nms_dispatch, boxes, scores, 0.5, 64), ref)
    assert_same(pallas_nms(boxes, scores, 0.5, 64), ref)


def test_nms_batch_equals_per_image_jax():
    scenes = [scene(10 + i, 150) for i in range(3)]
    boxes = np.stack([s[0] for s in scenes])
    scores = np.stack([s[1] for s in scenes])
    idx, valid = port(tk.nms_dispatch, boxes, scores, 0.6, 40)
    for i in range(3):
        assert_same((idx[i], valid[i]),
                    jax_nms(boxes[i], scores[i], 0.6, 40))


def test_batched_nms_dispatch_class_offset_equals_jax():
    boxes, scores = scene(8, 256, extent=600.0, size=(20.0, 120.0))
    classes = np.random.default_rng(9).integers(1, 21, 256).astype(np.int32)
    mask = scores > 0.1
    offset = jnms.coordinate_offset_for(1024.0)
    assert offset == tnms.coordinate_offset_for(1024.0) == 4096.0
    ref = jk.batched_nms_dispatch(jnp.asarray(boxes), jnp.asarray(scores),
                                  jnp.asarray(classes), 0.5, 100,
                                  valid_mask=jnp.asarray(mask),
                                  coordinate_offset=offset)
    out = tk.batched_nms_dispatch(torch.from_numpy(boxes),
                                  torch.from_numpy(scores),
                                  torch.from_numpy(classes), 0.5, 100,
                                  valid_mask=torch.from_numpy(mask),
                                  coordinate_offset=offset)
    assert_same((out[0].numpy(), out[1].numpy()),
                (np.asarray(ref[0]), np.asarray(ref[1])))


def test_class_aware_select_hard_equals_jax():
    boxes, scores = scene(11, 300, extent=500.0, size=(20.0, 150.0))
    classes = np.random.default_rng(12).integers(1, 4, 300).astype(np.int32)
    mask = scores > 0.05
    ref = jk.class_aware_select(jnp.asarray(boxes), jnp.asarray(scores),
                                jnp.asarray(classes), 0.5, 100,
                                valid_mask=jnp.asarray(mask),
                                coordinate_offset=4096.0)
    out = tk.class_aware_select(torch.from_numpy(boxes),
                                torch.from_numpy(scores),
                                torch.from_numpy(classes), 0.5, 100,
                                valid_mask=torch.from_numpy(mask),
                                coordinate_offset=4096.0)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    # Gathered from the same inputs: the scores are exactly equal too.
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("method", ["soft_linear", "soft_gaussian"])
def test_class_aware_select_soft_methods_not_ported(method):
    """The soft methods, once refused, now run Soft-NMS: tpudet's indices,
    validity and decayed scores (``tests/test_torch_soft_nms.py`` has the
    fuzzed cases)."""
    boxes, scores = scene(13, 16)
    classes = np.ones(16, np.int32)
    out = tk.class_aware_select(torch.from_numpy(boxes),
                                torch.from_numpy(scores),
                                torch.from_numpy(classes), 0.5, 8,
                                method=method, prune_threshold=0.05)
    ref = jk.class_aware_select(jnp.asarray(boxes), jnp.asarray(scores),
                                jnp.asarray(classes), 0.5, 8, method=method,
                                prune_threshold=0.05, use_pallas=False)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=0,
                               atol=1e-6)
    # Decayed, not the gathered originals (the Gaussian decays every
    # overlap; no pair here overlaps above the linear threshold).
    if method == "soft_gaussian":
        assert (out[1][out[2]]
                < torch.from_numpy(scores)[out[0].long()][out[2]]).any()


def test_kernel_plain_version_keep_walk():
    """The kernel's plain version (sorted positions of the kept boxes)
    agrees with the JAX kernel's keep mask."""
    boxes, scores = scene(14, 512)
    order = np.argsort(-scores, kind="stable")
    sorted_boxes = boxes[order]
    cand = np.ones(512, bool)
    cand[::7] = False
    pos, valid = tk_nms.nms_keep(torch.from_numpy(sorted_boxes)[None],
                                 torch.from_numpy(cand)[None], 0.7, 300)
    from tpudet.kernels.nms import _nms_keep_mask
    keep = np.asarray(_nms_keep_mask(jnp.asarray(sorted_boxes),
                                     jnp.asarray(cand), 0.7, 300,
                                     interpret=True))
    kept = np.flatnonzero(keep)[:300]
    n = int(valid.sum())
    assert n == min(300, keep.sum())
    np.testing.assert_array_equal(pos[0, :n].numpy(), kept[:n])
    assert not valid[0, n:].any() and (pos[0, n:] == 0).all()


def test_kernel_wrapper_refuses_cpu_tensors():
    boxes, _ = scene(15, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tk_nms.nms_keep_cuda(torch.from_numpy(boxes)[None],
                             torch.ones(1, 8, dtype=torch.bool), 0.5, 4)
