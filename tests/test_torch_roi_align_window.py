"""FPN RoI Align of the PyTorch port against the JAX package: the level
assignment (``fpn_assign_levels``) and the plain multi-level pooler
(``roi_align_levels``, the CPU path and the reference of the Hopper kernel
in ``tpudet_torch.kernels.roi_align_window``).

Levels must be equal ints: a level is a discrete decision, and a RoI at
another level pools other features. The reference is the JAX function
under ``jax.jit``, as the model runs it (XLA fuses its two multiply-adds
and turns its divisions by constants into reciprocal multiplies, which
moves boxes within an ulp of a level boundary; the eager JAX function can
differ from it there).

Pooled values, f32: within ``1e-4`` of JAX's windowed pooler
(``roi_align_window``), its Pallas kernel in interpret mode and its
all-level masked sum (measured: within 5e-7). bf16: JAX's windowed pooler
rounds its bilinear weights and their products to bf16 before an
f32-accumulated contraction, the port keeps f32 weights; on features drawn
from N(0, 1) the two differ by up to 2^-6 (measured over 4 seeds and
windows 24 and 56), so the bf16 tolerance is ``atol 2^-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.kernels.roi_align_window import roi_align_window_pallas_batched
from tpudet.ops import roi_align as jra
from tpudet_torch.kernels import roi_align_window as krw
from tpudet_torch.ops import roi_align as tra

torch.set_num_threads(2)
STRIDES = (4.0, 8.0, 16.0, 32.0)
ATOL = 1e-4
BF16_ATOL = 2.0 ** -5


def nudged(value, steps):
    """``value`` moved ``steps`` f32 ulps up (or down, if negative)."""
    v = np.float32(value)
    for _ in range(abs(steps)):
        v = np.nextafter(v, np.float32(np.inf if steps > 0 else -np.inf),
                         dtype=np.float32)
    return v


def boundary_boxes():
    """Boxes within a few ulps of every level boundary: square and 4:1
    boxes whose sqrt(area) / 224 is near a power of two, and slivers whose
    longer side / (window - 12) is near one, at integer and fractional
    origins (so ``x2 - x1`` rounds too)."""
    out = []
    for side in (56.0, 112.0, 224.0, 448.0):
        for x0 in (0.0, 10.3, 100.7, 500.0):
            for d in range(-6, 7):
                s = nudged(side, d)
                out.append([x0, x0, np.float32(x0) + s, np.float32(x0) + s])
                out.append([x0, 3.0, np.float32(x0) + 2 * s, 3.0 + s / 2])
    for span in (12.0, 24.0, 44.0, 48.0, 88.0, 96.0, 176.0, 192.0, 352.0,
                 704.0):
        for x0 in (0.0, 7.9, 300.1):
            for d in range(-6, 7):
                s = nudged(span, d)
                out.append([x0, 20.0, np.float32(x0) + s, 24.0])
                out.append([5.0, x0, 9.0, np.float32(x0) + s])
    return np.asarray(out, np.float32)


def random_boxes(seed, n=20000):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1300, (n, 2))
    wh = np.exp(rng.uniform(-1, 7, (n, 2)))
    boxes = np.concatenate([xy, xy + wh], 1)
    boxes[:4] = [[0.0, 0.0, 3.0, 200.0], [100.0, 2.0, 300.0, 6.0],
                 [50.0, 50.0, 52.5, 52.5], [7.0, 7.0, 7.0, 7.0]]
    return boxes.astype(np.float32)


@pytest.mark.parametrize("fit_window", [0, 24, 56])
@pytest.mark.parametrize("kind", ["boundary", "random"])
def test_fpn_assign_levels_equal_jax(kind, fit_window):
    boxes = boundary_boxes() if kind == "boundary" else random_boxes(fit_window)
    ref = np.asarray(jax.jit(lambda b: jra.fpn_assign_levels(
        b, fit_window=fit_window))(jnp.asarray(boxes)))
    out = tra.fpn_assign_levels(torch.from_numpy(boxes), fit_window=fit_window)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(np.unique(ref)) == 4  # every level is reached
    # Batched boxes give the same levels.
    np.testing.assert_array_equal(
        tra.fpn_assign_levels(torch.from_numpy(boxes[:100]).reshape(4, 25, 4),
                              fit_window=fit_window).reshape(-1).numpy(),
        ref[:100])


def test_fpn_assign_levels_refuses_small_window():
    with pytest.raises(ValueError, match="fit_window"):
        tra.fpn_assign_levels(torch.zeros(2, 4), fit_window=12)


def pyramid(rng, b, c=8):
    """Non-square p2..p5 of a 208 x 336 canvas (``tests/test_roi_align.py``'s
    ``_pyramid``), ``[B, H_l, W_l, C]`` each."""
    return [rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
            for h, w in ((52, 84), (26, 42), (13, 21), (7, 11))]


def hard_rois(rng, b, n):
    """Random RoIs plus the hard cases: a border sliver, a tall sliver, a
    tiny box, a canvas-sized box, a zero-area box and a corner sliver."""
    xy1 = rng.uniform(0, 200, (b, n, 2))
    wh = rng.uniform(8, 250, (b, n, 2))
    rois = np.concatenate([xy1, np.minimum(xy1 + wh, 330.0)], -1)
    hard = [[0.0, 0.0, 3.0, 200.0], [100.0, 2.0, 300.0, 6.0],
            [50.0, 50.0, 52.5, 52.5], [0.0, 0.0, 208.0, 330.0],
            [40.0, 40.0, 40.0, 40.0], [329.0, 329.0, 330.0, 330.0]]
    flat = rois.reshape(-1, 4)
    flat[1:1 + len(hard)] = hard  # across the image seam when n is small
    return flat.reshape(b, n, 4).astype(np.float32)


def port_pool(feats, rois, window, dtype=torch.float32):
    levels = tra.fpn_assign_levels(torch.from_numpy(rois),
                                   fit_window=window) - 2
    out = krw.roi_align_window([torch.from_numpy(f).to(dtype) for f in feats],
                               STRIDES, torch.from_numpy(rois), levels, 7, 2)
    return out, levels.numpy()


@pytest.mark.parametrize("window", [24, 56])
def test_plain_pooler_equals_jax_windowed_and_masked_sum(window):
    rng = np.random.default_rng(window)
    b, n = 3, 5  # B x N = 15, not a multiple of the TPU kernel's 4 RoIs/step
    feats, rois = pyramid(rng, b), hard_rois(rng, b, n)
    out, levels = port_pool(feats, rois, window)
    assert out.shape == (b, n, 7, 7, 8) and out.dtype == torch.float32
    for i in range(b):
        fi = [jnp.asarray(f[i]) for f in feats]
        ref = jra.roi_align_window(fi, STRIDES, jnp.asarray(rois[i]),
                                   jnp.asarray(levels[i]), 7, 2, window=window)
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)
        masked = sum(
            np.asarray(jra.roi_align_mxu(f, jnp.asarray(rois[i]) / st, 7, 2))
            * (levels[i] == li)[:, None, None, None]
            for li, (f, st) in enumerate(zip(fi, STRIDES)))
        np.testing.assert_allclose(out[i].numpy(), masked, rtol=0, atol=ATOL)


def test_plain_pooler_equals_pallas_interpret():
    rng = np.random.default_rng(7)
    b, n, window = 3, 5, 24
    feats, rois = pyramid(rng, b), hard_rois(rng, b, n)
    out, levels = port_pool(feats, rois, window)
    ref = roi_align_window_pallas_batched(
        [jnp.asarray(f) for f in feats], STRIDES, jnp.asarray(rois),
        jnp.asarray(levels), 7, 2, window=window, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("window", [24, 56])
def test_plain_pooler_bf16_within_measured_tolerance_of_jax(window):
    rng = np.random.default_rng(10 + window)
    b, n = 2, 32
    feats, rois = pyramid(rng, b, c=32), hard_rois(rng, b, n)
    out, levels = port_pool(feats, rois, window, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    for i in range(b):
        ref = jra.roi_align_window(
            [jnp.asarray(f[i]).astype(jnp.bfloat16) for f in feats], STRIDES,
            jnp.asarray(rois[i]), jnp.asarray(levels[i]), 7, 2, window=window)
        np.testing.assert_allclose(out[i].float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("c,s,r", [(12, 7, 2), (12, 14, 3)])
def test_plain_pooler_at_the_kernels_edge_shapes_equals_jax(c, s, r):
    """The shapes that take the Hopper kernel's other paths: C = 12, which
    16-byte vectors of bf16 do not divide, and S * r > 32 (S = 14, r = 3);
    ``hard_rois`` adds a zero-area box and slivers. Held to JAX's windowed
    pooler and to its gather form per level."""
    rng = np.random.default_rng(30 + s)
    b, n, window = 2, 6, 56
    feats, rois = pyramid(rng, b, c=c), hard_rois(rng, b, n)
    levels = tra.fpn_assign_levels(torch.from_numpy(rois),
                                   fit_window=window) - 2
    out = krw.roi_align_window([torch.from_numpy(f) for f in feats], STRIDES,
                               torch.from_numpy(rois), levels, s, r).numpy()
    assert out.shape == (b, n, s, s, c)
    levels = levels.numpy()
    for i in range(b):
        fi = [jnp.asarray(f[i]) for f in feats]
        ref = jra.roi_align_window(fi, STRIDES, jnp.asarray(rois[i]),
                                   jnp.asarray(levels[i]), s, r, window=window)
        np.testing.assert_allclose(out[i], np.asarray(ref), rtol=0, atol=ATOL)
        gather = sum(
            np.asarray(jra.roi_align(f, jnp.asarray(rois[i]) / st, s, r))
            * (levels[i] == li)[:, None, None, None]
            for li, (f, st) in enumerate(zip(fi, STRIDES)))
        np.testing.assert_allclose(out[i], gather, rtol=0, atol=ATOL)


def test_unknown_level_pools_to_zeros():
    rng = np.random.default_rng(3)
    feats, rois = pyramid(rng, 1), hard_rois(rng, 1, 8)
    levels = torch.tensor([[0, 1, 2, 3, 4, -1, 0, 0]], dtype=torch.int32)
    out = krw.roi_align_window([torch.from_numpy(f) for f in feats], STRIDES,
                               torch.from_numpy(rois), levels, 7, 2)
    assert (out[0, 4:6] == 0).all() and (out[0, :4] != 0).any()


def test_kernel_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(4)
    feats, rois = pyramid(rng, 1), hard_rois(rng, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        krw.roi_align_window_cuda([torch.from_numpy(f) for f in feats],
                                  STRIDES, torch.from_numpy(rois),
                                  torch.zeros(1, 8, dtype=torch.int32), 7, 2)
    assert krw.REPLACES == "tpudet/kernels/roi_align_window.py:109"
