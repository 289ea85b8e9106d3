"""Weight carry-over from the JAX package: a Flax variables tree -> a
``DetectorCore`` state dict.

The tree is ``{"params": ..., "constants": ...}`` as nested mappings of
arrays (numpy, or anything ``np.asarray`` takes). The port's module names
follow the Flax names, so the mapping is mechanical:

* a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW);
* a Dense ``kernel`` (``[in, out]``) becomes a Linear ``weight``
  (``[out, in]``); the RoI head flattens NHWC in both packages, so ``fc1``
  needs no row permutation;
* the FrozenBN constants ``scale/bias/mean/var`` become buffers of the same
  names;
* Flax's inner ``GroupNorm_0`` scope of ``AdaptiveGroupNorm_i`` is dropped.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def from_flax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "constants"}`` tree -> ``DetectorCore.state_dict()``
    layout (load with ``model.core.load_state_dict(sd)``)."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "constants"):
        for path, leaf in _flatten(variables.get(collection, {})):
            path = tuple(p for p in path if p != "GroupNorm_0")
            arr = np.array(leaf, dtype=np.float32)
            name = path[-1]
            if name == "kernel":
                name = "weight"
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            key = ".".join(path[:-1] + (name,))
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
