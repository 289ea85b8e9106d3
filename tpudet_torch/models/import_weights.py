"""Weight carry-over: a Flax variables tree -> the state dict of a model's
``core`` (``DetectorCore``, ``DeformableDETRCore``), and the pretrained
backbone converters (``tpudet.models.import_weights``).

The tree is ``{"params": ..., "constants": ...}`` as nested mappings of
arrays (numpy, or anything ``np.asarray`` takes). The port's module names
follow the Flax names, so the mapping is mechanical:

* a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW); a Flax
  ``ConvTranspose`` kernel (HW-in-out, applied unflipped; the layers named
  in ``CONV_TRANSPOSE_LAYERS``: the mask and keypoint heads' ``deconv`` and
  the simple feature pyramid's three) becomes torch's ``[in, out, kh, kw]``
  transposed-conv weight flipped in both spatial axes;
* a Dense ``kernel`` (``[in, out]``) becomes a Linear ``weight``
  (``[out, in]``); the RoI head flattens NHWC in both packages, so ``fc1``
  needs no row permutation;
* a ``DenseGeneral`` attention kernel (3-D) becomes a Linear weight over
  the flattened heads: ``query/key/value`` ``[d, heads, hd]`` ->
  ``[heads * hd, d]`` with their ``[heads, hd]`` biases flattened, ``out``
  ``[heads, hd, d]`` -> ``[d, heads * hd]``;
* the FrozenBN constants ``scale/bias/mean/var`` become buffers of the same
  names;
* Flax's inner ``GroupNorm_0`` scope of ``AdaptiveGroupNorm_i`` is dropped
  (its ``scale`` keeps the name); every other ``scale`` parameter (Flax's
  LayerNorm, ``MaskedGroupNorm``, the semantic head's ``nn.GroupNorm``
  layers ``p{l}_gn{j}``) becomes ``weight``;
* parameters that are no layer's (``level_embed``, ``query_embed``) keep
  their names and values.

``flax_param_ndims`` gives each port parameter the ndim of its Flax leaf,
for the optimizer's weight-decay mask.

The converters (``convert_keras_resnet``, ``convert_keras_vgg16``,
``convert_torch_resnet``, ``convert_torch_vgg16``, ``convert_torch_vit``)
return the JAX package's Flax-layout ``(params, constants)`` numpy trees of
the backbone, so an ``.npz`` of ``save_backbone_npz`` written by either
package loads in both; ``apply_backbone_weights`` merges such trees into a
model through ``from_flax_variables``. The Keras converters read any object
with Keras's ``layers`` (each with ``name`` and ``get_weights()``): this
module imports no TensorFlow.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import math

import numpy as np
import torch
from torch import nn

from tpudet_torch.models.detr import MultiHeadDotProductAttention
from tpudet_torch.models.layers import FrozenBatchNorm
from tpudet_torch.models.resnet import BASIC_BLOCK, STAGE_BLOCKS
from tpudet_torch.models.vgg import VGG16_STAGES
from tpudet_torch.models.vit import resize_pos_embed


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


# Flax ``ConvTranspose`` layers of the port's models, by name: the mask and
# keypoint heads' and the simple feature pyramid's.
CONV_TRANSPOSE_LAYERS = frozenset(
    {"deconv", "up4_deconv1", "up4_deconv2", "up2_deconv"})


def _kernel_to_weight(arr: np.ndarray, layer: str) -> np.ndarray:
    """A Flax kernel -> the port's weight: HWIO -> OIHW (a transposed
    conv's -> flipped IOHW), ``[in, out]`` -> ``[out, in]``, and the 3-D
    attention kernels over flattened heads."""
    if arr.ndim == 4:
        if layer in CONV_TRANSPOSE_LAYERS:
            return arr[::-1, ::-1].transpose(2, 3, 0, 1)
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 3:
        if layer == "out":  # [heads, hd, d] contracts over (heads, hd)
            return arr.reshape(-1, arr.shape[-1]).T
        return arr.reshape(arr.shape[0], -1).T  # [d, heads, hd]
    return arr.T


def from_flax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "constants"}`` tree -> ``model.core.state_dict()``
    layout (load with ``model.core.load_state_dict(sd)``)."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "constants"):
        for path, leaf in _flatten(variables.get(collection, {})):
            group_norm = "GroupNorm_0" in path
            path = tuple(p for p in path if p != "GroupNorm_0")
            arr = np.array(leaf, dtype=np.float32)
            name = path[-1]
            if name == "kernel":
                name = "weight"
                arr = _kernel_to_weight(arr, path[-2])
            elif name == "bias" and arr.ndim == 2:  # DenseGeneral [heads, hd]
                arr = arr.reshape(-1)
            elif (name == "scale" and collection == "params"
                  and not group_norm):
                name = "weight"
            key = ".".join(path[:-1] + (name,))
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def flax_param_ndims(module: nn.Module) -> Dict[str, int]:
    """Each parameter of ``module`` (a model's ``core``) -> the ndim of its
    leaf in the Flax params tree, which the JAX optimizer's weight-decay
    mask reads (``ndim >= 2`` decays). They agree but for the multi-head
    attention projections: Flax keeps the ``query``/``key``/``value`` biases
    as DenseGeneral ``[heads, hd]`` (ndim 2, decayed; the port's are
    flattened to 1-D) and the four kernels as 3-D."""
    ndims = {name: p.ndim for name, p in module.named_parameters()}
    for name, m in module.named_modules():
        if isinstance(m, MultiHeadDotProductAttention):
            prefix = f"{name}." if name else ""
            for proj in ("query", "key", "value"):
                ndims[f"{prefix}{proj}.weight"] = 3
                ndims[f"{prefix}{proj}.bias"] = 2
            ndims[f"{prefix}out.weight"] = 3
    return ndims


# ----------------------------------------------------------------------
# Pretrained backbones -> the JAX package's Flax-layout numpy trees.

Tree = Dict[str, Any]


def _np32(value) -> np.ndarray:
    """A tensor (any device) or array -> f32 numpy."""
    if hasattr(value, "detach"):
        value = value.detach().cpu().float().numpy()
    return np.asarray(value, np.float32)


def convert_keras_resnet(keras_model: Any, name: str = "resnet50"
                         ) -> Tuple[Tree, Tree]:
    """Keras-applications ResNet-50/101 -> (params, constants).

    ``conv1_conv``/``conv1_bn`` -> ``stem_conv``/``norm_stem``;
    ``conv{s}_block{b}_0_*`` (projection) -> ``stage{s}_block{b-1}``'s
    ``conv_proj``/``norm_proj``; ``conv{s}_block{b}_{1,2,3}_*`` ->
    ``conv{1,2,3}``/``norm{1,2,3}``. Keras's convs carry biases, which fold
    exactly into the frozen-BN mean (``x + bias - mean``). Keras strides the
    first 1x1, the port's default ``stride_in_1x1=True``."""
    layers = {layer.name: layer for layer in keras_model.layers}

    def conv_w(lname):
        w = layers[lname].get_weights()
        return _np32(w[0]), (_np32(w[1]) if len(w) > 1 else None)

    def bn_w(lname, conv_bias):
        gamma, beta, mean, var = (_np32(a)
                                  for a in layers[lname].get_weights())
        if conv_bias is not None:
            mean = mean - conv_bias
        return {"scale": gamma, "bias": beta, "mean": mean, "var": var}

    k, b = conv_w("conv1_conv")
    params: Tree = {"stem_conv": {"kernel": k}}
    constants: Tree = {"norm_stem": bn_w("conv1_bn", b)}
    for stage, n_blocks in enumerate(STAGE_BLOCKS[name]):
        ks = stage + 2
        for blk in range(n_blocks):
            kb = blk + 1  # Keras counts blocks from 1
            p: Tree = {}
            c: Tree = {}
            if blk == 0:
                k, b = conv_w(f"conv{ks}_block{kb}_0_conv")
                p["conv_proj"] = {"kernel": k}
                c["norm_proj"] = bn_w(f"conv{ks}_block{kb}_0_bn", b)
            for j in (1, 2, 3):
                k, b = conv_w(f"conv{ks}_block{kb}_{j}_conv")
                p[f"conv{j}"] = {"kernel": k}
                c[f"norm{j}"] = bn_w(f"conv{ks}_block{kb}_{j}_bn", b)
            params[f"stage{ks}_block{blk}"] = p
            constants[f"stage{ks}_block{blk}"] = c
    return params, constants


def convert_keras_vgg16(keras_model: Any) -> Tuple[Tree, Tree]:
    """Keras-applications VGG16 -> (params, {}): ``block{s}_conv{i}`` ->
    ``stage{s}/conv{s}_{i}``; HWIO kernels and biases in both, no norms."""
    layers = {layer.name: layer for layer in keras_model.layers}
    params: Tree = {}
    for stage, (n_convs, _) in enumerate(VGG16_STAGES, start=1):
        p: Tree = {}
        for i in range(1, n_convs + 1):
            w = layers[f"block{stage}_conv{i}"].get_weights()
            p[f"conv{stage}_{i}"] = {"kernel": _np32(w[0]),
                                     "bias": _np32(w[1])}
        params[f"stage{stage}"] = p
    return params, {}


def _torch_conv(state_dict, key: str) -> np.ndarray:
    """A torch ``[O, I, kh, kw]`` conv weight -> Flax's ``[kh, kw, I, O]``."""
    return np.transpose(_np32(state_dict[key + ".weight"]), (2, 3, 1, 0))


def convert_torch_resnet(state_dict: Mapping[str, Any],
                         name: str = "resnet50") -> Tuple[Tree, Tree]:
    """torchvision-layout ResNet state dict -> (params, constants).

    ``conv1``/``bn1`` (stem), ``layer{1..4}.{i}.conv{j}``/``bn{j}`` (j in
    1..3 for bottlenecks, 1..2 for the basic blocks of ResNet-18/34) and
    ``layer{s}.0.downsample.{0,1}`` (projection). torchvision strides the
    bottleneck's 3x3 ("v1.5"): build ResNet-50/101 with
    ``stride_in_1x1=False`` for these weights. Tensors or arrays."""

    def bn_w(prefix):
        return {"scale": _np32(state_dict[prefix + ".weight"]),
                "bias": _np32(state_dict[prefix + ".bias"]),
                "mean": _np32(state_dict[prefix + ".running_mean"]),
                "var": _np32(state_dict[prefix + ".running_var"])}

    params: Tree = {"stem_conv": {"kernel": _torch_conv(state_dict, "conv1")}}
    constants: Tree = {"norm_stem": bn_w("bn1")}
    convs = (1, 2) if name in BASIC_BLOCK else (1, 2, 3)
    for stage, n_blocks in enumerate(STAGE_BLOCKS[name]):
        for blk in range(n_blocks):
            t = f"layer{stage + 1}.{blk}"
            p: Tree = {}
            c: Tree = {}
            if f"{t}.downsample.0.weight" in state_dict:
                p["conv_proj"] = {
                    "kernel": _torch_conv(state_dict, f"{t}.downsample.0")}
                c["norm_proj"] = bn_w(f"{t}.downsample.1")
            for j in convs:
                p[f"conv{j}"] = {"kernel": _torch_conv(state_dict,
                                                       f"{t}.conv{j}")}
                c[f"norm{j}"] = bn_w(f"{t}.bn{j}")
            params[f"stage{stage + 2}_block{blk}"] = p
            constants[f"stage{stage + 2}_block{blk}"] = c
    return params, constants


def convert_torch_vgg16(state_dict: Mapping[str, Any]) -> Tuple[Tree, Tree]:
    """torchvision-layout VGG16 state dict -> (params, {}). ``features`` is
    a flat Sequential: conv, ReLU pairs with a max-pool after each stage,
    so the convs sit at 0, 2 | 5, 7 | 10, 12, 14 | 17, 19, 21 | 24, 26,
    28."""
    params: Tree = {}
    idx = 0
    for stage, (n_convs, _) in enumerate(VGG16_STAGES, start=1):
        p: Tree = {}
        for i in range(1, n_convs + 1):
            p[f"conv{stage}_{i}"] = {
                "kernel": _torch_conv(state_dict, f"features.{idx}"),
                "bias": _np32(state_dict[f"features.{idx}.bias"])}
            idx += 2  # conv, ReLU
        params[f"stage{stage}"] = p
        idx += 1  # max-pool
    return params, {}


def convert_torch_vit(state_dict: Mapping[str, Any],
                      pos_grid: int = 64) -> Tuple[Tree, Tree]:
    """timm/MAE-layout plain-ViT state dict -> (params, {}) for
    ``models.vit.ViT``.

    ``patch_embed.proj`` -> ``patch_embed``; ``pos_embed`` ``[1, (1+)g*g,
    D]`` loses a leading cls token and is resized (``resize_pos_embed``,
    f32) to ``pos_grid``; each block's fused ``attn.qkv`` ``[3D, D]`` splits
    into ``query``/``key``/``value`` (rows ``[0:D]``, ``[D:2D]``,
    ``[2D:3D]``), ``attn.proj`` -> ``attn/out``, ``mlp.fc{1,2}`` ->
    ``mlp_fc{1,2}``, and the LayerNorms ``norm1``, ``norm2`` and the final
    ``norm`` -> ``{scale, bias}``."""

    def arr(key):
        return _np32(state_dict[key])

    def lin(key):
        return {"kernel": arr(key + ".weight").T, "bias": arr(key + ".bias")}

    def ln(key):
        return {"scale": arr(key + ".weight"), "bias": arr(key + ".bias")}

    pw = arr("patch_embed.proj.weight")  # [D, 3, p, p]
    d = pw.shape[0]
    params: Tree = {"patch_embed": {
        "kernel": np.transpose(pw, (2, 3, 1, 0)),
        "bias": arr("patch_embed.proj.bias")}}
    pos = arr("pos_embed")
    n = pos.shape[1]
    g = math.isqrt(n)
    if g * g != n:
        if math.isqrt(n - 1) ** 2 != n - 1:
            raise ValueError(f"pos_embed length {n} is not a square grid")
        pos, g = pos[:, 1:], math.isqrt(n - 1)  # a leading cls token
    pos = torch.from_numpy(np.ascontiguousarray(pos.reshape(1, g, g, d)))
    params["pos_embed"] = resize_pos_embed(pos, (pos_grid, pos_grid)).numpy()
    i = 0
    while f"blocks.{i}.norm1.weight" in state_dict:
        qkv_w = arr(f"blocks.{i}.attn.qkv.weight").T  # [D, 3D]
        qkv_b = arr(f"blocks.{i}.attn.qkv.bias")
        attn = {name: {"kernel": qkv_w[:, j * d:(j + 1) * d],
                       "bias": qkv_b[j * d:(j + 1) * d]}
                for j, name in enumerate(("query", "key", "value"))}
        attn["out"] = lin(f"blocks.{i}.attn.proj")
        params[f"block{i}"] = {
            "norm1": ln(f"blocks.{i}.norm1"), "attn": attn,
            "norm2": ln(f"blocks.{i}.norm2"),
            "mlp_fc1": lin(f"blocks.{i}.mlp.fc1"),
            "mlp_fc2": lin(f"blocks.{i}.mlp.fc2")}
        i += 1
    params["norm"] = ln("norm")
    return params, {}


def save_backbone_npz(path: str, params: Tree, constants: Tree) -> None:
    """The trees as one ``.npz`` of ``params/a/b/kernel``-style keys (the
    JAX package's format)."""
    flat = {}
    for root, tree in (("params", params), ("constants", constants)):
        for keys, value in _flatten(tree, (root,)):
            flat["/".join(keys)] = np.asarray(value)
    np.savez(path, **flat)


def load_backbone_npz(path: str) -> Tuple[Tree, Tree]:
    """``save_backbone_npz``'s file -> (params, constants)."""
    params: Tree = {}
    constants: Tree = {}
    with np.load(path) as blob:
        for key in blob.files:
            parts = key.split("/")
            node = params if parts[0] == "params" else constants
            for part in parts[1:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = blob[key]
    return params, constants


def apply_backbone_weights(model: nn.Module, params: Tree,
                           constants: Tree) -> nn.Module:
    """Load converted backbone trees into ``model.core.backbone`` in place
    (through ``from_flax_variables`` under the ``backbone.`` prefix);
    returns ``model``. Refuses, as the JAX package does, a key the model
    lacks, a shape that differs, and BN constants into a model without
    frozen batch norms (``norm="gn"``)."""
    core = model.core
    if constants and not any(isinstance(m, FrozenBatchNorm)
                             for m in core.backbone.modules()):
        raise ValueError(
            "checkpoint carries frozen-BN constants but the model has no "
            "'constants' collection — it was built with norm='gn'; use "
            "BackboneConfig(norm='frozen_bn') to import pretrained BN "
            "statistics")
    state = core.state_dict()
    loaded = from_flax_variables({"params": {"backbone": params},
                                  "constants": {"backbone": constants}})
    for key, value in loaded.items():
        if key not in state:
            raise KeyError(f"no parameter {key!r} in model")
        if tuple(state[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: model "
                             f"{tuple(state[key].shape)}, import "
                             f"{tuple(value.shape)}")
    with torch.no_grad():
        for key, value in loaded.items():
            state[key].copy_(value)
    return model
