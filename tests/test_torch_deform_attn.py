"""Multi-scale deformable attention of the PyTorch port against the JAX
package: the plain op (``tpudet_torch.ops.deform_attn``, the CPU path and
the reference of the Hopper kernel in ``tpudet_torch.kernels.deform_attn``)
and its helpers.

Tolerances. Against ``ms_deform_attn_batched`` (the same gather and an f32
weighted sum in another summation order), f32 and bf16 values alike:
``atol 1e-5`` on N(0, 1) values (both promote bf16 values to f32 exactly
before the sum). Against the TPU kernel ``ms_deform_attn_mxu`` in interpret
mode: ``atol 4e-4``, the worst-case bound that ``tests/test_deform_attn_mxu.py``
derives for its bf16 hi/lo operand splits. Corner indices are equal ints.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudet.kernels.deform_attn_mxu import ms_deform_attn_mxu
from tpudet.ops import deform_attn as jda
from tpudet_torch.kernels import deform_attn as kda
from tpudet_torch.ops import deform_attn as tda

torch.set_num_threads(2)
ATOL = 1e-5
MXU_ATOL = 4e-4


def case(seed, b=2, q=13, heads=2, points=3, d=8,
         level_shapes=((6, 8), (3, 4), (1, 5)), span=0.4):
    """N(0, 1) values; locations in [-span, 1 + span], so some samples leave
    their level (the zero-padding path) and some fall on its border;
    weights softmaxed over L x P."""
    rng = np.random.default_rng(seed)
    n = sum(h * w for h, w in level_shapes)
    lv = len(level_shapes)
    values = rng.normal(0, 1, (b, n, heads, d)).astype(np.float32)
    loc = rng.uniform(-span, 1 + span,
                      (b, q, heads, lv, points, 2)).astype(np.float32)
    logits = rng.normal(0, 1, (b, q, heads, lv * points))
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return level_shapes, values, loc, w.reshape(b, q, heads, lv, points).astype(
        np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, dict(heads=8, d=32, points=4,
             level_shapes=((13, 13), (7, 7), (4, 4), (2, 2)))),
    (2, dict(q=1, heads=1, points=1, d=5, level_shapes=((1, 1),), span=1.5)),
])
def test_ms_deform_attn_batched_equals_jax(dtype, seed, kw):
    shapes, values, loc, w = case(seed, **kw)
    jv = jnp.asarray(values).astype(dtype)
    ref = np.asarray(jda.ms_deform_attn_batched(jv, shapes, jnp.asarray(loc),
                                                jnp.asarray(w)))
    tv = t(values).to(getattr(torch, dtype))
    out = tda.ms_deform_attn_batched(tv, shapes, t(loc), t(w))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    close(out, ref)
    assert np.abs(ref).max() > 0.1


def test_query_chunking_equals_jax():
    """Q = 37 over chunks of 8 (a ragged last chunk) and of 2048 (one)."""
    shapes, values, loc, w = case(3, q=37)
    ref = np.asarray(jda.ms_deform_attn_batched(
        jnp.asarray(values), shapes, jnp.asarray(loc), jnp.asarray(w),
        query_chunk=8))
    for chunk in (8, 2048):
        out = tda.ms_deform_attn_batched(t(values), shapes, t(loc), t(w),
                                         query_chunk=chunk)
        close(out, ref)


def test_single_image_op_equals_jax():
    shapes, values, loc, w = case(4, b=1)
    ref = np.asarray(jda.ms_deform_attn(jnp.asarray(values[0]), shapes,
                                        jnp.asarray(loc[0]),
                                        jnp.asarray(w[0])))
    close(tda.ms_deform_attn(t(values[0]), shapes, t(loc[0]), t(w[0])), ref)


def test_corner_indices_equal_and_weights_close():
    shapes, _, loc, w = case(5, span=0.6)
    offsets, _ = jda.level_start_offsets(shapes)
    jidx, jcw = jda._corner_index_weight(jnp.asarray(loc), jnp.asarray(w),
                                         shapes, offsets)
    tidx, tcw = tda._corner_index_weight(t(loc), t(w), shapes, offsets)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    close(tcw, jcw, 1e-7)
    assert (np.asarray(jcw) == 0).mean() > 0.1  # out-of-grid corners


@pytest.mark.parametrize("seed,kw", [
    (6, {}),
    (7, dict(heads=8, d=32, points=4, q=40,
             level_shapes=((13, 13), (7, 7), (4, 4), (2, 2)))),
])
def test_plain_op_equals_tpu_kernel_interpret(seed, kw):
    """The TPU kernel (both its banded and flat forms, by level height) in
    interpret mode, within its hi/lo split bound."""
    shapes, values, loc, w = case(seed, **kw)
    ref = np.asarray(ms_deform_attn_mxu(
        jnp.asarray(values), shapes, jnp.asarray(loc), jnp.asarray(w),
        interpret=True))
    out = tda.ms_deform_attn_batched(t(values), shapes, t(loc), t(w))
    close(out, ref, MXU_ATOL)


def test_dispatch_on_cpu_runs_the_plain_version():
    shapes, values, loc, w = case(8)
    before = kda.LAUNCHES
    out = kda.ms_deform_attn(t(values), shapes, t(loc), t(w))
    assert kda.LAUNCHES == before
    assert torch.equal(out, kda.ms_deform_attn_plain(t(values), shapes,
                                                     t(loc), t(w)))
    with pytest.raises(ValueError, match="CUDA"):
        kda.ms_deform_attn_cuda(t(values), shapes, t(loc), t(w))
    with pytest.raises(ValueError, match="sum to"):
        tda.ms_deform_attn_batched(t(values), shapes[:2], t(loc), t(w))


def test_level_reference_points_equal_jax():
    shapes = ((2, 3), (1, 1), (13, 21), (7, 5))
    ref = np.asarray(jda.level_reference_points(shapes))
    out = tda.level_reference_points(shapes)
    assert out.shape == ref.shape == (6 + 1 + 273 + 35, 2)
    close(out, ref, 0)


@pytest.mark.parametrize("h,lv,p", [(8, 4, 4), (4, 4, 2), (3, 2, 3)])
def test_sampling_offset_init_bias_equals_jax(h, lv, p):
    ref = np.asarray(jda.sampling_offset_init_bias(h, lv, p))
    out = tda.sampling_offset_init_bias(h, lv, p)
    assert out.shape == ref.shape == (h * lv * p * 2,)
    close(out, ref, 1e-6)


def test_inverse_sigmoid_equals_jax():
    x = np.array([-0.5, 0.0, 1e-7, 0.01, 0.25, 0.5, 0.9, 0.999, 1.0, 1.7],
                 np.float32)
    close(tda.inverse_sigmoid(t(x)), jda.inverse_sigmoid(jnp.asarray(x)), 1e-6)
