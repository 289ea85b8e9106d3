"""Weight carry-over from the JAX package: a Flax variables tree -> the
state dict of a model's ``core`` (``DetectorCore``, ``DeformableDETRCore``).

The tree is ``{"params": ..., "constants": ...}`` as nested mappings of
arrays (numpy, or anything ``np.asarray`` takes). The port's module names
follow the Flax names, so the mapping is mechanical:

* a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW); the mask and
  keypoint heads' ``deconv`` (Flax's ``ConvTranspose``, HW-in-out, applied
  unflipped) becomes torch's ``[in, out, kh, kw]`` transposed-conv weight
  flipped in both spatial axes;
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
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from tpudet_torch.models.detr import MultiHeadDotProductAttention


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _kernel_to_weight(arr: np.ndarray, layer: str) -> np.ndarray:
    """A Flax kernel -> the port's weight: HWIO -> OIHW (a transposed
    conv's -> flipped IOHW), ``[in, out]`` -> ``[out, in]``, and the 3-D
    attention kernels over flattened heads."""
    if arr.ndim == 4:
        if layer == "deconv":
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
