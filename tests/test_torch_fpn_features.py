"""ResNet-101 and the FPN levels of the PyTorch port against the JAX
package on the CPU, in f32 and bf16 (the features of ``coco_r101_fpn``).

Tolerances. f32: ``rtol/atol 1e-4`` (the two frameworks sum the
convolutions in other orders). bf16: both frameworks round each
convolution's output to bf16 but accumulate inside it differently, so the
features differ by bf16 roundings that add up with depth. Measured as the
largest difference over the level's largest value (two seeds each):
ResNet-101 c2..c5 0.0029, 0.0054, 0.0151, 0.0190 (tolerances 2^-7, 2^-6,
2^-5, 2^-5); FPN p2..p6 from the same c2..c5, 0.0071 (tolerance 2^-6).
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_faster_rcnn import close, t
from tpudet.models.fpn import FPN as JaxFPN
from tpudet.models.resnet import build_backbone as jax_backbone
from tpudet_torch.models.fpn import FPN
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.models.resnet import build_backbone

torch.set_num_threads(2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def random_constants(v, seed):
    """FrozenBN constants drawn at random (at init FrozenBN is the
    identity, which would hide a layout fault in the mapping)."""
    rng = np.random.default_rng(seed)
    flat = flax.traverse_util.flatten_dict(v["constants"])
    for key, leaf in flat.items():
        lo, hi = (0.5, 1.5) if key[-1] in ("scale", "var") else (-0.1, 0.1)
        flat[key] = rng.uniform(lo, hi, leaf.shape).astype(np.float32)
    v["constants"] = flax.traverse_util.unflatten_dict(flat)
    return v


def relative_close(port, ref, rel):
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= rel * np.abs(ref).max()


@functools.lru_cache(maxsize=None)
def resnet101_variables():
    """The Flax tree's shapes (``eval_shape``: a full init of ResNet-101
    takes ~16 s here) filled from numpy: conv kernels N(0, 1/fan_in)."""
    net = jax_backbone("resnet101", "frozen_bn", jnp.float32, True)
    shapes = flax.core.unfreeze(jax.eval_shape(
        net.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map(
        lambda x: rng.normal(0, np.prod(x.shape[:-1]) ** -0.5, x.shape
                             ).astype(np.float32), shapes)
    return random_constants(v, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet101_features_equal_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    v = resnet101_variables()
    images = np.random.default_rng(2).normal(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    ref = jax_backbone("resnet101", "frozen_bn", jdt, True).apply(v, images)
    net = build_backbone("resnet101", "frozen_bn", tdt)
    net.load_state_dict(from_flax_variables(v))
    assert len(net.blocks) == 4 and net.blocks[2] == 23
    with torch.no_grad():
        out = net(t(images).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
    for level, rel in (("c2", 2 ** -7), ("c3", 2 ** -6), ("c4", 2 ** -5),
                       ("c5", 2 ** -5)):
        got = out[level].permute(0, 2, 3, 1).float()
        if dtype == "float32":
            close(got, ref[level])
        else:
            relative_close(got, ref[level].astype(jnp.float32), rel)


# Canvases: square; non-square whose c5 sides are odd (3 x 5); the 832x1120
# COCO bucket's width (c5 35 cells wide -> p6 ceil(35 / 2) = 18).
FPN_CANVASES = {"64x64": (64, 64), "96x160": (96, 160), "32x1120": (32, 1120)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("canvas", list(FPN_CANVASES))
def test_fpn_levels_equal_jax(canvas, dtype):
    jdt, tdt = DTYPES[dtype]
    h, w = FPN_CANVASES[canvas]
    rng = np.random.default_rng(3)
    channels = {"c2": 16, "c3": 24, "c4": 32, "c5": 48}
    feats = {name: rng.normal(0, 1, (2, h // s, w // s, ch)).astype(np.float32)
             for (name, ch), s in zip(channels.items(), (4, 8, 16, 32))}
    v = flax.core.unfreeze(jax.tree_util.tree_map(
        np.array, JaxFPN(dtype=jnp.float32).init(jax.random.key(4), feats)))
    for leaf in jax.tree_util.tree_leaves(v):  # nonzero biases
        if leaf.ndim == 1:
            leaf[:] = rng.normal(0, 0.1, leaf.shape)
    ref = JaxFPN(dtype=jdt).apply(v, {k: jnp.asarray(x).astype(jdt)
                                      for k, x in feats.items()})
    fpn = FPN(channels, dtype=tdt)
    fpn.load_state_dict(from_flax_variables(v))
    with torch.no_grad():
        out = fpn({k: t(x).to(tdt).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last) for k, x in feats.items()})
    assert sorted(out) == ["p2", "p3", "p4", "p5", "p6"]
    if canvas == "32x1120":
        assert out["p5"].shape[3] == 35 and out["p6"].shape[3] == 18
    for name in out:
        got = out[name].permute(0, 2, 3, 1)
        assert got.shape == ref[name].shape
        if name != "p6":  # the NHWC view the pooler reads is a free permute
            assert got.is_contiguous()
        if dtype == "float32":
            close(got, ref[name])
        else:
            relative_close(got.float(), ref[name].astype(jnp.float32), 2 ** -6)
