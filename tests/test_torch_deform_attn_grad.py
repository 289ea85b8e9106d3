"""Gradients of the plain multi-scale deformable attention (the CPU path
and the reference of the Hopper backward kernel) against ``jax.grad`` of
the JAX package's ``ms_deform_attn_batched`` and of the TPU kernel
``ms_deform_attn_mxu`` in interpret mode, with samples outside their level
and on its border; and of the ``MSDeformAttn`` module with masked tokens.

Tolerances. Against ``ms_deform_attn_batched`` with f32 values, and for the
location and weight gradients with bf16 values (both widen the gathered
bf16 corners to f32 exactly), JAX's own tolerances of
``tests/test_deform_attn_mxu.py:114-122``: values and weights ``rtol 1e-4,
atol 1e-5``, locations ``rtol 1e-4, atol 1e-4``. The bf16 value gradient is
summed in bf16 by both frameworks' scatter-adds, in other orders: within
``2^-6`` of its largest magnitude. Against the TPU kernel: the bound that
test gives its banded form (``:156-158``: rtol 1e-3; atol 3e-5 for values,
3e-4 for locations and weights). The module: ``atol 1e-5`` of each
gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.kernels.deform_attn_mxu import ms_deform_attn_mxu
from tpudet.models import deformable_detr as jdd
from tpudet.ops import deform_attn as jda
from tpudet_torch.kernels import deform_attn as kda
from tpudet_torch.models import deformable_detr as tdd
from tpudet_torch.models.import_weights import from_flax_variables

torch.set_num_threads(2)
TOL = {"values": (1e-4, 1e-5), "locations": (1e-4, 1e-4),
       "weights": (1e-4, 1e-5)}


def case(seed, b=2, q=11, heads=2, points=2, d=8,
         level_shapes=((5, 6), (3, 3), (1, 4)), span=0.4):
    """N(0, 1) values; locations in [-span, 1 + span] (about a third of
    the samples leave their level), a few exactly on the level's edges;
    weights softmaxed over L x P; a cotangent with mixed signs."""
    rng = np.random.default_rng(seed)
    n = sum(h * w for h, w in level_shapes)
    lv = len(level_shapes)
    values = rng.normal(0, 1, (b, n, heads, d)).astype(np.float32)
    loc = rng.uniform(-span, 1 + span,
                      (b, q, heads, lv, points, 2)).astype(np.float32)
    loc[:, 0, :, :, 0, 0] = 0.0
    loc[:, -1, :, :, 0, 1] = 1.0
    logits = rng.normal(0, 1, (b, q, heads, lv * points))
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    w = w.reshape(b, q, heads, lv, points).astype(np.float32)
    cot = rng.normal(0, 1, (b, q, heads, d)).astype(np.float32)
    return level_shapes, values, loc, w, cot


def t(x):
    return torch.from_numpy(np.asarray(x))


def jax_grads(fn, values, shapes, loc, w, cot):
    def loss(v, lc, wt):
        return jnp.sum(fn(v, shapes, lc, wt) * cot)
    return [np.asarray(g, np.float32) for g in jax.jit(
        jax.grad(loss, argnums=(0, 1, 2)))(values, loc, w)]


def torch_grads(values, shapes, loc, w, cot, fn=kda.ms_deform_attn_plain):
    inputs = [values.requires_grad_(), t(loc).requires_grad_(),
              t(w).requires_grad_()]
    out = fn(inputs[0], shapes, inputs[1], inputs[2])
    return [g.float().numpy() for g in torch.autograd.grad(
        out, inputs, t(cot))]


def assert_grads(got, ref, skip=()):
    for name, g, r in zip(("values", "locations", "weights"), got, ref):
        if name in skip:
            continue
        rtol, atol = TOL[name]
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, dict(heads=8, d=32, points=4, q=9,
             level_shapes=((10, 10), (5, 5), (3, 3), (2, 2)))),
    (2, dict(q=1, heads=1, points=1, d=5, level_shapes=((1, 1),), span=1.5)),
])
def test_plain_gradients_equal_jax_f32(seed, kw):
    shapes, values, loc, w, cot = case(seed, **kw)
    ref = jax_grads(jda.ms_deform_attn_batched, jnp.asarray(values), shapes,
                    jnp.asarray(loc), jnp.asarray(w), jnp.asarray(cot))
    got = torch_grads(t(values), shapes, loc, w, cot)
    assert_grads(got, ref)
    assert np.abs(ref[1]).max() > 0.1


def test_plain_gradients_equal_jax_bf16_values():
    shapes, values, loc, w, cot = case(3, heads=4, d=16, points=3)
    jv = jnp.asarray(values, jnp.bfloat16)
    ref = jax_grads(jda.ms_deform_attn_batched, jv, shapes, jnp.asarray(loc),
                    jnp.asarray(w), jnp.asarray(cot))
    got = torch_grads(t(values).bfloat16(), shapes, loc, w, cot)
    assert_grads(got, ref, skip=("values",))
    scale = np.abs(ref[0]).max()
    assert np.abs(got[0] - ref[0]).max() <= 2 ** -6 * scale


@pytest.mark.parametrize("seed,kw", [
    (4, {}),
    (5, dict(heads=2, points=2, d=8, q=9, level_shapes=((40, 6), (3, 4)))),
])
def test_plain_gradients_equal_tpu_kernel_interpret(seed, kw):
    """The TPU backward kernels (the flat form, and with a 40-row level the
    banded one) in interpret mode, through their custom VJP."""
    shapes, values, loc, w, cot = case(seed, **kw)

    def mxu(v, s, lc, wt):
        return ms_deform_attn_mxu(v, s, lc, wt, query_tile=8, interpret=True)

    ref = jax_grads(mxu, jnp.asarray(values), shapes, jnp.asarray(loc),
                    jnp.asarray(w), jnp.asarray(cot))
    got = torch_grads(t(values), shapes, loc, w, cot)
    for name, g, r, tol in zip(("values", "locations", "weights"), got, ref,
                               (3e-5, 3e-4, 3e-4)):
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=tol, err_msg=name)


def test_dispatch_on_cpu_differentiates_the_plain_version():
    shapes, values, loc, w, cot = case(6)
    before = (kda.LAUNCHES, kda.BACKWARD_LAUNCHES)
    got = torch_grads(t(values), shapes, loc, w, cot, fn=kda.ms_deform_attn)
    assert (kda.LAUNCHES, kda.BACKWARD_LAUNCHES) == before
    ref = torch_grads(t(values), shapes, loc, w, cot)
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)
    with pytest.raises(ValueError, match="CUDA"):
        kda.ms_deform_attn_backward_cuda(t(values), shapes, t(loc), t(w),
                                         t(cot))


@pytest.mark.parametrize("box_ref", [False, True])
def test_ms_deform_attn_module_gradients_equal_jax(box_ref):
    """MSDeformAttn with a fifth of the tokens masked (their values zeroed,
    so samples on them contribute nothing): the gradients of every
    parameter and of the query, memory and reference inputs."""
    rng = np.random.default_rng(7)
    shapes = ((6, 8), (3, 4), (2, 2))
    b, nq, d = 2, 10, 32
    n = sum(h * w for h, w in shapes)
    query = rng.normal(0, 1, (b, nq, d)).astype(np.float32)
    memory = rng.normal(0, 1, (b, n, d)).astype(np.float32)
    ref_xy = rng.uniform(0, 1, (b, nq, 3, 2)).astype(np.float32)
    ref_wh = (rng.uniform(0.05, 0.6, (b, nq, 3, 2)).astype(np.float32)
              if box_ref else None)
    valid = rng.uniform(size=(b, n)) > 0.2
    cot = rng.normal(0, 1, (b, nq, d)).astype(np.float32)
    jm = jdd.MSDeformAttn(d, 4, 3, 2, jnp.float32, gather="mxu")
    args = (query, ref_xy, ref_wh, memory, valid)
    v = jax.jit(lambda k: jm.init(k, *args, shapes))(jax.random.key(0))
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(0, 0.2, x.shape), jnp.float32),
        v["params"])
    params["sampling_offsets"]["bias"] = v["params"]["sampling_offsets"]["bias"]

    def loss(p, qr, mem, rxy, rwh):
        out = jm.apply({"params": p}, qr, rxy, rwh, mem, valid, shapes)
        return jnp.sum(out * cot)

    argnums = (0, 1, 2, 3, 4) if box_ref else (0, 1, 2, 3)
    grads = jax.jit(jax.grad(loss, argnums=argnums))(
        params, query, memory, ref_xy, ref_wh)
    ref_params = from_flax_variables({"params": grads[0]})

    tm = tdd.MSDeformAttn(d, 4, 3, 2, torch.float32, gather="mxu")
    tm.load_state_dict(from_flax_variables({"params": params}))
    inputs = [t(x).requires_grad_() for x in (query, memory, ref_xy)]
    wh = t(ref_wh).requires_grad_() if box_ref else None
    out = tm(inputs[0], inputs[2], wh, inputs[1], t(valid), shapes)
    (out * t(cot)).sum().backward()
    for name, p in tm.named_parameters():
        want = ref_params[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    got = [x.grad for x in inputs] + ([wh.grad] if box_ref else [])
    for g, want in zip(got, grads[1:]):
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    # The sampling locations are differentiated, not constant.
    assert np.abs(ref_params["sampling_offsets.weight"].numpy()).max() > 0.01
