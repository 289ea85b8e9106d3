"""The maps' gradient of the port's FPN RoI Align (autograd through the
plain pooler: the CPU path of FPN training and the reference of the
backward kernel) against the JAX package's training pooler
``tpudet.ops.roi_align.roi_align_window_train_batched``: its Pallas
forward in interpret mode and, for the gradient, the ``jax.linear_transpose``
of its per-level masked sum, on the CPU.

Both get the same maps, boxes and cotangent, drawn with numpy from a seed;
the port's levels are ``fpn_assign_levels(boxes, fit_window=window) - 2``,
as tpudet's own. The RoIs sit on all four levels, across the border and
wholly off the map, with a zero-area box and slivers that the window bumps
up a level.

Tolerances: f32 within ``atol 1e-5`` (the same products summed in another
order). bf16 maps: the port sums in f32 and rounds once (as the kernel
does); tpudet's transpose rounds its bilinear weights to bf16 first, so the
two agree to ``2^-6`` of the gradient's largest magnitude (as the C4
gradient against ``roi_align_mxu``, ``tests/test_torch_roi_align_grad.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_roi_align_window import STRIDES, hard_rois, pyramid
from tpudet.ops import roi_align as jra
from tpudet_torch.kernels import roi_align_window as krw
from tpudet_torch.ops import roi_align as tra

torch.set_num_threads(2)
S, R = 7, 2
BF16_TOL = 2.0 ** -6


def inputs(seed, window, b=2, n=12, c=8):
    """A 208 x 336 canvas's p2..p5, RoIs with the hard cases of
    ``hard_rois`` plus, in each image, one across the top-left border, one
    wholly off the map and one larger than the map (at p5), a cotangent;
    the levels they get."""
    rng = np.random.default_rng(seed)
    feats, rois = pyramid(rng, b, c), hard_rois(rng, b, n)
    rois[:, -1] = [-90.0, -80.0, -20.0, -15.0]  # wholly off the map
    rois[:, -2] = [-40.0, -30.0, 70.0, 45.0]  # across the border
    rois[:, -3] = [-150.0, -120.0, 420.0, 380.0]  # over the map: p5
    cot = rng.normal(0, 1, (b, n, S, S, c)).astype(np.float32)
    levels = tra.fpn_assign_levels(torch.from_numpy(rois),
                                   fit_window=window) - 2
    return feats, rois, cot, levels


def jax_grads(feats, rois, cot, window, dtype):
    """tpudet's VJP of ``roi_align_window_train_batched``: the maps'
    gradient in ``dtype`` (as f32) and the boxes'."""
    def pool(fs, boxes):
        return jra.roi_align_window_train_batched(
            fs, STRIDES, boxes, S, R, window=window, interpret=True)

    @jax.jit
    def vjp(fs, boxes, g):
        out, back = jax.vjp(pool, fs, boxes)
        return back(g.astype(out.dtype))

    d_feats, d_boxes = vjp([jnp.asarray(f, dtype) for f in feats],
                           jnp.asarray(rois), jnp.asarray(cot, dtype))
    return [np.asarray(g, np.float32) for g in d_feats], np.asarray(d_boxes)


def port_grads(feats, rois, cot, levels, dtype):
    """Autograd through the port's pooler on the CPU: the maps' gradient
    in ``dtype`` (as f32) and the boxes' (None: the boxes are data)."""
    maps = [torch.from_numpy(f).to(dtype).requires_grad_() for f in feats]
    boxes = torch.from_numpy(rois).requires_grad_()
    out = krw.roi_align_window(maps, STRIDES, boxes, levels, S, R)
    assert out.dtype == dtype
    grads = torch.autograd.grad(out, maps + [boxes],
                                torch.from_numpy(cot).to(dtype),
                                allow_unused=True)
    # A map that no RoI pools from is not in the graph: its gradient is 0.
    maps_grad = [torch.zeros_like(m) if g is None else g
                 for m, g in zip(maps, grads[:-1])]
    assert all(g.dtype == dtype for g in maps_grad)
    return [g.float().numpy() for g in maps_grad], grads[-1]


@pytest.mark.parametrize("seed,window", [(0, 24), (1, 56), (5, 24)])
def test_f32_map_gradients_equal_jax(seed, window):
    feats, rois, cot, levels = inputs(seed, window)
    assert set(levels.reshape(-1).tolist()) == {0, 1, 2, 3}
    ref, ref_boxes = jax_grads(feats, rois, cot, window, jnp.float32)
    got, got_boxes = port_grads(feats, rois, cot, levels, torch.float32)
    for level, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5,
                                   err_msg=f"level {level}")
        assert np.abs(r).max() > 0.1, level
    # The boxes get no gradient: zeros in tpudet's VJP, none in the port.
    assert not ref_boxes.any() and got_boxes is None


def test_bf16_map_gradients_within_tolerance_of_jax():
    feats, rois, cot, levels = inputs(3, 24)
    ref, _ = jax_grads(feats, rois, cot, 24, jnp.bfloat16)
    got, _ = port_grads(feats, rois, cot, levels, torch.bfloat16)
    top = max(np.abs(r).max() for r in ref)
    for level, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g, r, rtol=0, atol=BF16_TOL * top,
                                   err_msg=f"level {level}")
    # The port's bf16 gradient is its f32 gradient of the same bf16-rounded
    # inputs, rounded once.
    def rounded(x):
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()

    f32, _ = port_grads([rounded(f) for f in feats], rois, rounded(cot),
                        levels, torch.float32)
    for g, r in zip(got, f32):
        np.testing.assert_array_equal(g, rounded(r))


def test_rois_outside_the_levels_and_off_the_map_add_nothing():
    feats, rois, cot, levels = inputs(4, 56, b=1)
    # Off the map at its own level, and at levels that name no map.
    outside = levels.clone()
    outside[0, :-1] = torch.tensor([-1, 4], dtype=torch.int32).repeat(
        rois.shape[1])[:rois.shape[1] - 1]
    got, _ = port_grads(feats, rois, cot, outside, torch.float32)
    assert not any(g.any() for g in got)
