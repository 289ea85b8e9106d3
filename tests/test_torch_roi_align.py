"""RoI Align of the PyTorch port against the JAX package.

The port's plain gather form (the CPU path of the pooler and the reference
of the Hopper kernel) is held against ``tpudet.ops.roi_align.roi_align``,
``roi_align_mxu`` and ``roi_align_pallas`` in interpret mode. Tolerance:
f32 ``atol 1e-5``, the summation-order difference of four bilinear terms
and an r x r mean over features of magnitude ~1. Interpret mode unrolls the
Pallas kernel's S x S x r x r samples, so its case keeps R <= 16, C <= 32
and S = 3 (S = 7 takes minutes to trace on the CPU).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpudet.kernels.roi_align import roi_align_pallas
from tpudet.ops import roi_align as jra
from tpudet_torch.kernels import roi_align as tk_ra
from tpudet_torch.ops import roi_align as tra

torch.set_num_threads(2)
ATOL = 1e-5


def inputs(seed, h=12, w=17, c=32, r=16):
    """Feature map and RoIs in feature coordinates: inside, crossing every
    border, degenerate (zero width or height, a point) and fully outside."""
    rng = np.random.default_rng(seed)
    feat = rng.normal(0, 1, (h, w, c)).astype(np.float32)
    xy = rng.uniform(-3, max(h, w), (r, 2))
    wh = rng.uniform(0.5, 8, (r, 2))
    rois = np.concatenate([xy, xy + wh], axis=1)
    rois[0] = [-2.0, -1.5, 4.0, 3.0]          # crosses the top-left corner
    rois[1] = [w - 3.0, h - 2.0, w + 2.5, h + 1.0]  # crosses bottom-right
    rois[2] = [3.0, 4.0, 3.0, 9.0]            # zero width
    rois[3] = [5.0, 2.0, 5.0, 2.0]            # a point
    rois[4] = [w + 2.0, h + 2.0, w + 6.0, h + 5.0]  # outside the map
    return feat, rois.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_roi_align_equals_jax_gather_and_mxu(seed):
    feat, rois = inputs(seed)
    ref = np.asarray(jra.roi_align(jnp.asarray(feat), jnp.asarray(rois), 7, 2))
    out = tra.roi_align(torch.from_numpy(feat), torch.from_numpy(rois), 7,
                        2).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    mxu = np.asarray(jra.roi_align_mxu(jnp.asarray(feat), jnp.asarray(rois),
                                       7, 2))
    np.testing.assert_allclose(out, mxu, rtol=0, atol=ATOL)


def test_roi_align_equals_pallas_interpret():
    feat, rois = inputs(6)
    pallas = np.asarray(roi_align_pallas(jnp.asarray(feat), jnp.asarray(rois),
                                         3, 2, interpret=True))
    out = tra.roi_align(torch.from_numpy(feat), torch.from_numpy(rois), 3,
                        2).numpy()
    np.testing.assert_allclose(out, pallas, rtol=0, atol=ATOL)


@pytest.mark.parametrize("h,w", [(12, 17), (19, 9)])
def test_roi_align_mxu_equals_jax(h, w):
    # Both contraction orders (w >= h and w < h).
    feat, rois = inputs(2, h=h, w=w)
    ref = np.asarray(jra.roi_align_mxu(jnp.asarray(feat), jnp.asarray(rois),
                                       7, 2))
    out = tra.roi_align_mxu(torch.from_numpy(feat), torch.from_numpy(rois), 7,
                            2).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_batched_wrapper_equals_per_image_jax():
    """The kernel wrapper's CPU path: B images, one image index per RoI, in
    the order the model pools them."""
    feats, rois = zip(*(inputs(10 + i, r=6) for i in range(3)))
    feat = np.stack(feats)
    flat = np.concatenate(rois)
    index = np.repeat(np.arange(3, dtype=np.int32), 6)
    out = tk_ra.roi_align(torch.from_numpy(feat), torch.from_numpy(flat),
                          torch.from_numpy(index), 7, 2).numpy()
    for i in range(3):
        ref = np.asarray(jra.roi_align(jnp.asarray(feat[i]),
                                       jnp.asarray(rois[i]), 7, 2))
        np.testing.assert_allclose(out[6 * i:6 * (i + 1)], ref, rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("c,s,r,offset", [(12, 7, 2, 0), (6, 7, 2, 0),
                                          (12, 14, 3, 0), (32, 7, 2, 1)])
def test_wrapper_at_the_kernels_edge_shapes_equals_jax(c, s, r, offset):
    """The shapes that take the Hopper kernel's other paths, through the
    wrapper's CPU path: C that 16-byte vectors do not divide (12 bf16 or 6
    f32 channels), S * r > 32 (S = 14, r = 3), and a features view that
    starts one element into its storage (on the card, a base that is not
    16-byte aligned); ``inputs`` adds RoIs of zero width, a point and one
    off the map."""
    feat, rois = inputs(20 + c + s, c=c)
    storage = np.zeros(offset + feat.size, np.float32)
    storage[offset:] = feat.reshape(-1)
    view = torch.from_numpy(storage)[offset:].view(1, *feat.shape)
    out = tk_ra.roi_align(view, torch.from_numpy(rois),
                          torch.zeros(len(rois), dtype=torch.int32), s,
                          r).numpy()
    ref = np.asarray(jra.roi_align(jnp.asarray(feat), jnp.asarray(rois), s, r))
    assert out.shape == (16, s, s, c)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    assert (out[4] == 0).all()  # the RoI off the map


def test_output_size_and_sampling_ratio():
    feat, rois = inputs(3, c=8)
    ref = np.asarray(jra.roi_align(jnp.asarray(feat), jnp.asarray(rois), 5, 3))
    out = tra.roi_align(torch.from_numpy(feat), torch.from_numpy(rois), 5,
                        3).numpy()
    assert out.shape == (16, 5, 5, 8)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_bf16_features_pool_in_f32():
    """bf16 input: sampling and the mean run in f32 and round once to bf16,
    so the result is the f32 pooling of the same bf16 values rounded to
    bf16 (exactly, or by one bf16 ulp at a rounding boundary)."""
    feat, rois = inputs(4)
    feat16 = torch.from_numpy(feat).to(torch.bfloat16)
    out = tra.roi_align(feat16, torch.from_numpy(rois), 7, 2)
    assert out.dtype == torch.bfloat16
    ref = tra.roi_align(feat16.float(), torch.from_numpy(rois), 7, 2)
    torch.testing.assert_close(out.float(), ref, rtol=2 ** -8, atol=1e-6)


def test_kernel_wrapper_refuses_cpu_tensors():
    feat, rois = inputs(5, r=6)
    with pytest.raises(ValueError, match="CUDA"):
        tk_ra.roi_align_cuda(torch.from_numpy(feat)[None],
                             torch.from_numpy(rois),
                             torch.zeros(6, dtype=torch.int32), 7, 2)
