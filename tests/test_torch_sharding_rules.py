"""The port's tensor-parallel layout (``tpudet_torch.parallel.sharding_rules``)
against the JAX package's ``_spec_for_path``, leaf for leaf.

For the tiny config of each family that the JAX package cuts (Faster R-CNN,
FPN, Cascade R-CNN, DETR, Deformable DETR, ViTDet), the JAX train state
(parameters, optimizer state, EMA) is traced with ``jax.eval_shape``, and
each leaf's ``PartitionSpec`` is taken from tpudet's rules on its path. A
leaf of the Flax shape, numbered 0..n-1, is cut by that spec for each of
two model ranks, and the whole leaf and each cut go through the converter
(``models.import_weights.from_flax_variables``): the port's ``tp_layout``
must cut the converted whole leaf into exactly the converted cuts (or name
it replicated where the spec is ``P()``). The optimizer's state and the EMA
follow their parameter in both packages.
"""

import numpy as np
import pytest
import torch

import jax
from tpudet import config as jconfig
from tpudet.models import build_model as jax_build_model
from tpudet.parallel import sharding_rules as jrules
from tpudet.train.state import create_train_state as jax_create_train_state
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.parallel.sharding_rules import (
    REPLICATED,
    _spec_for_path,
    flax_paths,
    tp_layout,
)

FAMILIES = {
    "faster_rcnn": ("tiny_test_config", {}),
    "fpn": ("tiny_test_config", {"use_fpn": True}),
    "cascade": ("tiny_cascade_config", {}),
    "detr": ("tiny_detr_config", {}),
    "deformable_detr": ("tiny_deformable_detr_config", {}),
    "vitdet": ("tiny_vitdet_config", {}),
}


def configs(family):
    name, kw = FAMILIES[family]
    return getattr(jconfig, name)(**kw), getattr(tconfig, name)(**kw)


def jax_state_leaves(cfg):
    """(path, ShapeDtypeStruct) of every leaf of the JAX train state, the
    EMA on."""
    train = cfg.train.__class__(**{**cfg.train.__dict__, "ema_decay": 0.9})
    model = jax_build_model(cfg)
    state = jax.eval_shape(lambda k: jax_create_train_state(model, train, k),
                           jax.random.key(0))
    return [(jrules._path_str(path), leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(state)[0]]


def nest(path, value):
    """``a/b/c`` -> {"a": {"b": {"c": value}}}."""
    tree = value
    for part in reversed(path.split("/")):
        tree = {part: tree}
    return tree


def converted(param_path, arr):
    """The port tensor of the Flax leaf at ``param_path`` (under params)."""
    (tensor,) = from_flax_variables({"params": nest(param_path, arr)}).values()
    return tensor


def cut(arr, spec, rank, size=2):
    """Rank ``rank``'s block of ``arr`` under the JAX ``spec``."""
    if "model" not in spec:
        return arr
    axis = tuple(spec).index("model")
    step = arr.shape[axis] // size
    return np.take(arr, np.arange(rank * step, (rank + 1) * step), axis=axis)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_layout_equals_jax_spec_on_every_leaf(family):
    jcfg, tcfg = configs(family)
    model = build_model(tcfg, device="cpu")
    layout = tp_layout(model, 2)
    names = {path[len("params/"):]: name
             for name, (path, _) in flax_paths(model.core).items()}
    assert set(layout) == set(dict(model.core.named_parameters()))
    leaves = jax_state_leaves(jcfg)
    param_paths = [p[len("params/"):] for p, _ in leaves
                   if p.startswith("params/")]
    assert sorted(param_paths) == sorted(names), \
        set(param_paths) ^ set(names)
    seen = {"params": 0, "opt_state": 0, "ema_params": 0}
    sharded = 0
    for path, leaf in leaves:
        spec = tuple(jrules._spec_for_path(path, leaf))
        owner = [p for p in param_paths
                 if path == "params/" + p or path.endswith("/" + p)]
        if not owner:  # the step, the rng, the frozen constants
            assert spec == (), path
            continue
        param = max(owner, key=len)
        seen[path.split("/")[0]] += 1
        shard = layout[names[param]]
        arr = np.arange(np.prod(leaf.shape), dtype=np.float32).reshape(
            leaf.shape)
        whole = converted(param, arr)
        if spec == ():
            assert shard == REPLICATED, (path, shard)
            continue
        sharded += 1
        assert shard.kind in ("column", "row"), (path, shard)
        for rank in range(2):
            step = whole.shape[shard.dim] // 2
            got = whole.narrow(shard.dim, rank * step, step)
            torch.testing.assert_close(
                got, converted(param, cut(arr, spec, rank)), rtol=0, atol=0,
                msg=f"{path} rank {rank}")
        # The copy of the rule gives the JAX rule's spec.
        assert _spec_for_path(path, leaf.ndim) == spec, path
    # Parameters, an optimizer state and an EMA entry for every parameter,
    # and something is cut.
    assert seen["params"] == seen["ema_params"] == len(param_paths)
    assert seen["opt_state"] >= len(param_paths)
    assert sharded > 0


def test_one_wide_model_axis_replicates_everything():
    _, tcfg = configs("detr")
    layout = tp_layout(build_model(tcfg, device="cpu"), 1)
    assert set(layout.values()) == {REPLICATED}


@pytest.mark.parametrize("family,expect", [
    ("faster_rcnn", {"det_head.fc1.weight": ("column", 0),
                     "det_head.fc1.bias": ("column", 0),
                     "det_head.fc2.weight": ("row", 1),
                     "det_head.fc2.bias": ("replicated", None),
                     "det_head.cls.weight": ("replicated", None)}),
    ("cascade", {"det_head3.fc1.weight": ("column", 0),
                 "det_head3.fc2.weight": ("row", 1)}),
    ("detr", {"enc0.self_attn.query.weight": ("column", 0),
              "enc0.self_attn.query.bias": ("column", 0),
              "dec0.cross_attn.out.weight": ("row", 1),
              "dec0.cross_attn.out.bias": ("replicated", None),
              "enc0.ffn.fc1.weight": ("column", 0),
              "enc0.ffn.fc2.weight": ("row", 1)}),
    ("deformable_detr", {"enc0.deform_attn.value.weight": ("column", 0),
                         "dec0.cross_attn.value.bias": ("column", 0),
                         "dec0.cross_attn.out.weight": ("row", 1),
                         "enc0.deform_attn.sampling_offsets.weight":
                         ("replicated", None),
                         "dec1.cross_attn.attention_weights.weight":
                         ("replicated", None)}),
    ("vitdet", {"backbone.block0.attn.key.weight": ("column", 0),
                "backbone.block1.attn.out.weight": ("row", 1),
                "backbone.block0.mlp_fc1.bias": ("column", 0),
                "backbone.block0.mlp_fc2.weight": ("row", 1)}),
])
def test_layout_names_the_megatron_cuts(family, expect):
    _, tcfg = configs(family)
    layout = tp_layout(build_model(tcfg, device="cpu"), 2)
    for name, (kind, dim) in expect.items():
        assert (layout[name].kind, layout[name].dim) == (kind, dim), name
