"""The features' gradient of the port's plain RoI Align (the CPU path of
training, and the reference of the backward kernel) against ``jax.grad``
through the JAX package's ``roi_align_mxu`` (what its training pools
through) and ``roi_align`` (the gather form), on the CPU.

Boxes cover the map's border, lie wholly off it, and are degenerate (zero
width, inverted), so the border rule's zeroed and clamped samples are in
the gradient too.

Tolerances: f32 within ``1e-5`` (sums of the same products in other
orders). bf16 features: the port sums in f32 and rounds once (as the
kernel does); JAX's einsum rounds its interpolation weights to bf16 first
and its gather form accumulates in bf16, so they agree to ``2^-6`` (einsum)
and ``2^-4`` (gather) of the gradient's largest magnitude (measured: 2^-7.5
and 2^-4.7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.ops import roi_align as jra
from tpudet_torch.ops import roi_align as tra

torch.set_num_threads(2)


def inputs(seed, b=2, h=9, w=13, c=6, n=7, s=5, r=2):
    rng = np.random.default_rng(seed)
    feat = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    xy = rng.uniform(-2, 10, (b, n, 2))
    wh = rng.uniform(0.5, 8, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 0] = [3.0, 2.0, 3.0, 7.0]  # zero width
    boxes[:, 1] = [-9.0, -8.0, -2.0, -1.5]  # off the map
    boxes[:, 2] = [6.0, 5.0, 4.0, 3.0]  # inverted
    boxes[:, 3] = [-1.0, -1.0, float(w) + 1, float(h) + 1]  # over the border
    cot = rng.normal(0, 1, (b, n, s, s, c)).astype(np.float32)
    return feat, boxes, cot, s, r


def jax_grad(fn, feat, boxes, cot, s, r, dtype):
    def pooled(f):
        return jnp.stack([fn(f[i], jnp.asarray(boxes[i]), s, r)
                          for i in range(f.shape[0])])

    out, vjp = jax.vjp(pooled, jnp.asarray(feat, dtype))
    # The gather form returns f32 for bf16 features: the same (bf16-rounded)
    # cotangent in the output's dtype.
    (g,) = vjp(jnp.asarray(cot, dtype).astype(out.dtype))
    return np.asarray(g, np.float32)


def port_grad(feat, boxes, cot, s, r, dtype):
    b, n = boxes.shape[:2]
    f = torch.from_numpy(feat).to(dtype).requires_grad_()
    index = torch.arange(b, dtype=torch.int32).repeat_interleave(n)
    out = tra.roi_align_batched(f, torch.from_numpy(boxes).reshape(-1, 4),
                                index, s, r)
    assert out.dtype == dtype
    (g,) = torch.autograd.grad(out, f, torch.from_numpy(cot).reshape(
        out.shape).to(dtype))
    assert g.dtype == dtype
    return g.float().numpy()


@pytest.mark.parametrize("form", ["mxu", "gather"])
@pytest.mark.parametrize("seed,shape", [
    (0, {}), (1, dict(s=7, r=2, c=3)), (2, dict(h=4, w=3, s=2, r=3))])
def test_f32_feature_gradient_equals_jax(form, seed, shape):
    feat, boxes, cot, s, r = inputs(seed, **shape)
    fn = jra.roi_align_mxu if form == "mxu" else jra.roi_align
    ref = jax_grad(fn, feat, boxes, cot, s, r, jnp.float32)
    got = port_grad(feat, boxes, cot, s, r, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert np.abs(ref).max() > 0.1
    # Wholly off-map RoIs give no gradient; the border rule clamps the rest.
    assert got.shape == feat.shape


@pytest.mark.parametrize("form,tol", [("mxu", 2 ** -6), ("gather", 2 ** -4)])
def test_bf16_feature_gradient_equals_jax(form, tol):
    feat, boxes, cot, s, r = inputs(3)
    fn = jra.roi_align_mxu if form == "mxu" else jra.roi_align
    ref = jax_grad(fn, feat, boxes, cot, s, r, jnp.bfloat16)
    got = port_grad(feat, boxes, cot, s, r, torch.bfloat16)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())
    # The port's bf16 gradient is its f32 gradient of the same bf16 inputs,
    # rounded once.
    f32 = port_grad(np.asarray(torch.from_numpy(feat).to(torch.bfloat16)
                               .float()), boxes,
                    np.asarray(torch.from_numpy(cot).to(torch.bfloat16)
                               .float()), s, r, torch.float32)
    np.testing.assert_array_equal(
        got, torch.from_numpy(f32).to(torch.bfloat16).float().numpy())


def test_off_map_roi_has_no_gradient():
    feat, boxes, cot, s, r = inputs(4, b=1)
    only = boxes[:, 1:2]  # the RoI wholly off the map
    got = port_grad(feat, only, cot[:, 1:2], s, r, torch.float32)
    assert not got.any()
