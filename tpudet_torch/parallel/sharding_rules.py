"""Tensor-parallel layout of the parameters (``tpudet.parallel.sharding_rules``).

The JAX package names a ``PartitionSpec`` for each leaf of the train state
over the ``("data", "model")`` mesh and lets XLA's partitioner insert the
collectives. With a nontrivial "model" axis the wide MLPs and the attention
projections are cut Megatron-style: a column-parallel layer (its output
features, at head boundaries for attention) followed by a row-parallel one
(its input features), everything else replicated. Here ``tp_layout`` gives
each parameter of a port model the same cut, read from the same rules
(``_spec_for_path``) on the parameter's Flax path and leaf rank, which the
converter's name map (``models.import_weights.from_flax_variables``) defines.
So the port's layout is the JAX package's by construction;
``models.layers.shard_model`` applies it and the Dense layers run the
collectives themselves (``models.layers``).

A Flax Dense kernel is ``[in, out]``; the port's weight is ``[out, in]``,
so a cut of the Flax output axis is a cut of the port's dim 0 (column
parallel) and a cut of the input axis one of dim 1 (row parallel). The
attention ``DenseGeneral`` kernels flatten their heads: query/key/value
``[d, heads, hd]`` cut at the heads is the port's ``[heads * hd, d]`` cut at
dim 0, ``out`` ``[heads, hd, d]`` cut at the heads the port's ``[d, heads *
hd]`` cut at dim 1. The optimizer's state and the EMA follow their
parameter (the JAX rules are name-based and reach them the same way).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from torch import nn

from tpudet_torch.models.import_weights import flax_param_ndims
from tpudet_torch.models.layers import (
    AdaptiveGroupNorm,
    Conv,
    ConvTranspose,
    Dense,
)

MODEL = "model"
Spec = Tuple[Optional[str], ...]  # a PartitionSpec's entries; () replicates


@dataclasses.dataclass(frozen=True)
class Shard:
    """How one parameter is laid out over the model group: ``kind`` is
    "replicated", "column" (output features cut) or "row" (input features
    cut), and ``dim`` the dimension of the port's tensor that is cut (None
    when replicated)."""

    kind: str
    dim: Optional[int] = None


REPLICATED = Shard("replicated")


def _spec_for_path(path: str, ndim: int) -> Spec:
    """The JAX package's rule for the leaf at Flax ``path`` of rank
    ``ndim``: a copy of ``tpudet.parallel.sharding_rules._spec_for_path``
    over the rank instead of the leaf. ``tests/test_torch_sharding_rules.py``
    holds it to the JAX function leaf for leaf."""
    if "det_head" in path:
        if path.endswith("fc1/kernel") and ndim == 2:
            return (None, MODEL)
        if path.endswith("fc1/bias") and ndim == 1:
            return (MODEL,)
        if path.endswith("fc2/kernel") and ndim == 2:
            return (MODEL, None)
    # DETR attention, sharded over the heads: query/key/value [d, heads,
    # hd] column-parallel, out [heads, hd, d] row-parallel.
    if "self_attn" in path or "cross_attn" in path:
        if path.endswith("out/kernel") and ndim == 3:
            return (MODEL, None, None)
        if ndim == 3 and any(path.endswith(f"{p}/kernel")
                             for p in ("query", "key", "value")):
            return (None, MODEL, None)
        if ndim == 2 and any(path.endswith(f"{p}/bias")
                             for p in ("query", "key", "value")):
            return (MODEL, None)
    # Deformable attention: value column-parallel (its columns reshape to
    # heads x head_dim), out row-parallel; offsets and attention weights
    # replicated.
    if "deform_attn" in path or "cross_attn" in path:
        if path.endswith("value/kernel") and ndim == 2:
            return (None, MODEL)
        if path.endswith("value/bias") and ndim == 1:
            return (MODEL,)
        if path.endswith("out/kernel") and ndim == 2:
            return (MODEL, None)
    if "/ffn/" in path:
        if path.endswith("fc1/kernel") and ndim == 2:
            return (None, MODEL)
        if path.endswith("fc1/bias") and ndim == 1:
            return (MODEL,)
        if path.endswith("fc2/kernel") and ndim == 2:
            return (MODEL, None)
    # ViT blocks: query/key/value column-parallel, out row-parallel, the
    # MLP column then row.
    if "/attn/" in path:
        if path.endswith("out/kernel") and ndim == 2:
            return (MODEL, None)
        if ndim == 2 and any(path.endswith(f"{p}/kernel")
                             for p in ("query", "key", "value")):
            return (None, MODEL)
        if ndim == 1 and any(path.endswith(f"{p}/bias")
                             for p in ("query", "key", "value")):
            return (MODEL,)
    if path.endswith("mlp_fc1/kernel") and ndim == 2:
        return (None, MODEL)
    if path.endswith("mlp_fc1/bias") and ndim == 1:
        return (MODEL,)
    if path.endswith("mlp_fc2/kernel") and ndim == 2:
        return (MODEL, None)
    return ()


def flax_paths(core: nn.Module) -> Dict[str, Tuple[str, int]]:
    """Each parameter of ``core`` -> (its Flax path in the JAX train
    state's ``params``, slash-joined, and the rank of the Flax leaf): the
    inverse of ``from_flax_variables``'s name map. A conv or Dense
    ``weight`` is Flax's ``kernel``, a norm's ``weight`` its ``scale``, and
    an ``AdaptiveGroupNorm``'s parameters sit in Flax's inner
    ``GroupNorm_0`` scope."""
    ndims = flax_param_ndims(core)
    modules = dict(core.named_modules())
    out = {}
    for name in ndims:
        owner, _, leaf = name.rpartition(".")
        module = modules[owner]
        parts = owner.split(".") if owner else []
        if leaf == "weight":
            leaf = ("kernel" if isinstance(module, (Conv, ConvTranspose, Dense))
                    else "scale")
        if isinstance(module, AdaptiveGroupNorm):
            parts.append("GroupNorm_0")
        out[name] = ("/".join(["params"] + parts + [leaf]), ndims[name])
    return out


def _port_dim(spec: Spec, ndim: int, flax_path: str) -> Optional[int]:
    """The port tensor's dimension that a Flax spec cuts (see the module
    docstring), or None."""
    if MODEL not in spec:
        return None
    axis = spec.index(MODEL)
    if not flax_path.endswith("/kernel"):
        return 0  # a bias: [out] or [heads, hd] flattened, cut at dim 0
    if ndim == 2:
        return 1 - axis  # [in, out] -> [out, in]
    if flax_path.endswith("out/kernel"):
        return 1  # [heads, hd, d] -> [d, heads * hd]
    return 0  # query/key/value [d, heads, hd] -> [heads * hd, d]


def tp_layout(model: nn.Module, model_size: int = 2) -> Dict[str, Shard]:
    """Each parameter name of ``model`` (a model or its ``core``) -> its
    ``Shard``. With ``model_size == 1`` everything is replicated, as the
    JAX package's ``train_state_shardings`` is on a one-wide model axis."""
    core = getattr(model, "core", model)
    layout = {}
    for name, (path, ndim) in flax_paths(core).items():
        dim = (None if model_size == 1
               else _port_dim(_spec_for_path(path, ndim), ndim, path))
        if dim is None:
            layout[name] = REPLICATED
        elif name.endswith(".bias") or dim == 0:
            layout[name] = Shard("column", 0)
        else:
            layout[name] = Shard("row", dim)
    return layout
