"""Faster R-CNN's training targets in the PyTorch port against ``tpudet``'s,
on the CPU: the cross-boundary anchor mask, the IoU matcher and the
balanced sampler. All must agree exactly (labels, indices, masks).

The JAX sampler draws its two uniforms with ``jax.random``; the port's
takes them as inputs. The tests hand the port the uniforms JAX draws from
its own keys (``split(key) -> uniform``), or plant draws in both (JAX's
``jax.random.uniform`` patched for the call) to force ties.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.ops import anchors as janchors
from tpudet.ops import boxes as jboxes
from tpudet.ops import samplers as jsamplers
from tpudet.ops.matchers import match_boxes as jax_match
from tpudet_torch.ops import anchors as tanchors
from tpudet_torch.ops import boxes as tboxes
from tpudet_torch.ops.matchers import match_boxes
from tpudet_torch.ops.samplers import draw_uniforms, sample_balanced

torch.set_num_threads(2)

RPN = dict(fg_thresh=0.7, bg_thresh=0.3, allow_low_quality=True)
ROI = dict(fg_thresh=0.5, bg_thresh=0.5, bg_thresh_lo=0.0)
ROI_LO = dict(fg_thresh=0.5, bg_thresh=0.5, bg_thresh_lo=0.1)


def random_boxes(rng, shape, extent=128.0):
    xy = rng.uniform(-10, extent, shape + (2,))
    wh = rng.uniform(2, 60, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_anchor_validity_mask_equals_jax():
    anchors = janchors.generate_anchors_np(8, 10, 16, (32.0, 64.0),
                                           (0.5, 1.0, 2.0))
    hw = np.array([[128, 160], [100, 90.5]], np.float32)
    for h, w in hw:
        ref = np.asarray(janchors.anchor_validity_mask_np(
            jnp.asarray(anchors), jnp.float32(h), jnp.float32(w)))
        np_out = tanchors.anchor_validity_mask_np(anchors, h, w)
        np.testing.assert_array_equal(np_out, ref)
        assert 0 < ref.sum() < len(ref)
    batched = tanchors.anchor_validity_mask_np(
        torch.from_numpy(anchors), torch.from_numpy(hw[:, 0:1]),
        torch.from_numpy(hw[:, 1:2]))
    assert batched.shape == (2, len(anchors))
    for i, (h, w) in enumerate(hw):
        np.testing.assert_array_equal(
            batched[i].numpy(), janchors.anchor_validity_mask_np(anchors, h, w))


def iou_cases():
    """``{name: (iou [B, N, G], gt_valid [B, G])}`` from boxes through each
    package's ``pairwise_iou`` (checked equal): random boxes; tied ones
    (duplicated anchors and ground truth, so the argmax and the per-GT
    best tie); a batch whose second image has only padding; and one with
    no valid ground truth at all."""
    rng = np.random.default_rng(0)
    cases = {}
    anchors = random_boxes(rng, (2, 60))
    gt = random_boxes(rng, (2, 5))
    valid = np.array([[1, 1, 1, 0, 1], [1, 0, 1, 1, 0]], bool)
    cases["random"] = (anchors, gt, valid)
    tied_a = anchors.copy()
    tied_a[:, 10:20] = tied_a[:, 0:10]  # duplicate anchors
    tied_g = gt.copy()
    tied_g[:, 1] = tied_g[:, 0]  # duplicate ground truth
    tied_g[:, 2] = anchors[:, 5]  # a ground-truth box equal to an anchor
    cases["tied"] = (tied_a, tied_g, np.ones((2, 5), bool))
    cases["one_image_padded"] = (anchors, gt, np.array([[1, 1, 0, 0, 0],
                                                        [0, 0, 0, 0, 0]], bool))
    cases["all_padded"] = (anchors, gt, np.zeros((2, 5), bool))
    out = {}
    for name, (a, g, v) in cases.items():
        ref = np.stack([np.asarray(jboxes.pairwise_iou(jnp.asarray(a[i]),
                                                       jnp.asarray(g[i])))
                        for i in range(len(a))])
        port = tboxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(g))
        np.testing.assert_array_equal(port.numpy(), ref)
        out[name] = (ref, v)
    return out


CASES = iou_cases()


@pytest.mark.parametrize("setting", ["rpn", "roi", "roi_lo"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_match_boxes_equals_jax(case, setting):
    iou, valid = CASES[case]
    kw = {"rpn": RPN, "roi": ROI, "roi_lo": ROI_LO}[setting]
    ref = jax.vmap(functools.partial(jax_match, **kw))(jnp.asarray(iou),
                                                       gt_valid=jnp.asarray(valid))
    idx, labels = match_boxes(torch.from_numpy(iou), gt_valid=torch.from_numpy(valid),
                              **kw)
    assert idx.dtype == labels.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref[1]))
    if case == "all_padded":
        assert (labels == 0).all()
    elif case == "tied" and setting == "rpn":
        assert (labels == 1).sum() >= 4  # ties of the per-GT best


def sampler_labels(rng, b, n, p_pos, p_neg):
    u = rng.uniform(size=(b, n))
    return np.where(u < p_pos, 1, np.where(u < p_pos + p_neg, 0, -1)).astype(
        np.int32)


def jax_sample(labels, keys, k, frac):
    """JAX's sampler per image -> (indices, is_pos, valid) and the uniforms
    it drew from each key."""
    n = labels.shape[1]
    fn = jax.jit(jax.vmap(functools.partial(
        jsamplers.sample_balanced, num_samples=k, positive_fraction=frac)))
    out = fn(jnp.asarray(labels), keys)

    def draws(key):
        rng_pos, rng_tie = jax.random.split(key)
        return (jax.random.uniform(rng_pos, (n,)),
                jax.random.uniform(rng_tie, (n,)))

    pos, tie = jax.vmap(draws)(keys)
    return [np.asarray(x) for x in out], (np.array(pos), np.array(tie))


def assert_same_samples(port, ref):
    idx, is_pos, valid = port
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), ref[0])
    np.testing.assert_array_equal(is_pos.numpy(), ref[1])
    np.testing.assert_array_equal(valid.numpy(), ref[2])


@pytest.mark.parametrize("n,k,frac,p_pos,p_neg", [
    (400, 64, 0.5, 0.05, 0.6),     # RPN-like: few positives, many negatives
    (300, 32, 0.25, 0.3, 0.5),     # RoI-like: more positives than k_pos
    (200, 64, 0.5, 0.02, 0.1),     # fewer candidates than K
    (150, 32, 0.25, 0.0, 0.8),     # no positives at all
    (100, 32, 0.5, 0.0, 0.0),      # nothing to sample
])
def test_sample_balanced_equals_jax_given_its_uniforms(n, k, frac, p_pos, p_neg):
    rng = np.random.default_rng(n + k)
    labels = sampler_labels(rng, 3, n, p_pos, p_neg)
    keys = jax.random.split(jax.random.key(n), 3)
    ref, (pos, tie) = jax_sample(labels, keys, k, frac)
    port = sample_balanced(torch.from_numpy(labels), torch.from_numpy(pos),
                           torch.from_numpy(tie), k, frac)
    assert_same_samples(port, ref)
    candidates = (labels >= 0).sum(1)
    np.testing.assert_array_equal(ref[2].sum(1), np.minimum(candidates, k))


def test_sample_balanced_equals_jax_with_planted_ties(monkeypatch):
    """Draws on a grid of 1/8 (and 1 - 2^-24, where ``1 + u`` rounds to 2)
    make both top-ks break ties: the order must be ``lax.top_k``'s."""
    rng = np.random.default_rng(3)
    n, k, frac = 120, 32, 0.5
    labels = sampler_labels(rng, 2, n, 0.2, 0.5)
    pos = (rng.integers(0, 8, (2, n)) / 8).astype(np.float32)
    tie = (rng.integers(0, 8, (2, n)) / 8).astype(np.float32)
    tie[:, ::17] = np.float32(1 - 2 ** -24)
    ref = []
    for i in range(2):
        queue = [jnp.asarray(pos[i]), jnp.asarray(tie[i])]
        monkeypatch.setattr(jax.random, "uniform",
                            lambda key, shape, q=queue: q.pop(0))
        ref.append([np.asarray(x) for x in jsamplers.sample_balanced(
            jnp.asarray(labels[i]), jax.random.key(0), k, frac)])
        monkeypatch.undo()
    ref = [np.stack([r[j] for r in ref]) for j in range(3)]
    port = sample_balanced(torch.from_numpy(labels), torch.from_numpy(pos),
                           torch.from_numpy(tie), k, frac)
    assert_same_samples(port, ref)
    assert ref[1].sum() > 2 * int(round(k * frac)) - 2  # positives fill k_pos


def test_draw_uniforms_follow_the_generator():
    a = draw_uniforms(torch.Generator().manual_seed(4), 2, 50)
    b = draw_uniforms(torch.Generator().manual_seed(4), 2, 50)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (2, 50) and a[0].dtype == torch.float32
    assert not torch.equal(a[0], a[1])
    assert 0 <= float(a[0].min()) and float(a[0].max()) < 1
