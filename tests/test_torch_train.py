"""The port's optimizer, schedule, EMA decay and train state against
``tpudet.train.state`` and optax, on the CPU; the 20-step learning check
of ``tests/test_deformable_detr.py::test_loss_decreases_and_trains``; and
``chip_smoke.py``'s learning checks of the Cascade R-CNN, Keypoint R-CNN
and Panoptic FPN tiny presets at tpudet's bars.

The optimizer tests drive ``make_train_step`` with a stand-in model whose
loss is ``sum_p <c_p, p>``, so every gradient is a chosen array ``c_p``,
and apply the JAX package's ``make_optimizer`` chain to the same gradients
on the Flax tree of the tiny Deformable DETR (every parameter redrawn, so
biases are nonzero and decay shows). Covered: gradient clipping (it
triggers), the warmup factor of the first updates, the decay mask by the
Flax leaf's ndim (the self-attention's ``[heads, hd]`` biases decay),
``backbone_lr_factor``, ``train.freeze`` (bit-identical) and parameters
without a gradient (behind ``freeze_stem``: zero in JAX, which still
decays them).

Tolerances: parameters after two updates within ``1e-6`` relative and
``1e-7`` absolute (the same f32 update, the terms added in other orders);
the schedule within ``1e-6`` relative of JAX's (a cosine an ulp apart),
the EMA decay equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_deformable_detr import make_batch as jax_make_batch
from tpudet import config as jconfig
from tpudet.models import DeformableDETR as JaxDeformableDETR
from tpudet.train import state as jstate
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import (
    flax_param_ndims,
    from_flax_variables,
)
from tpudet_torch.train import state as tstate
from tpudet_torch.train.step import make_train_step

torch.set_num_threads(2)


def train_configs(**fields):
    """The tiny Deformable DETR config in both packages with ``fields`` in
    its train group."""
    return [mod.tiny_deformable_detr_config().replace(train=dataclasses.replace(
        mod.tiny_deformable_detr_config().train, **fields))
        for mod in (jconfig, tconfig)]


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("fields", [
    dict(warmup_steps=4, lr_milestones=(6, 6, 9), lr_gamma=0.1),
    dict(lr_schedule="cosine", warmup_steps=3, total_steps=10,
         lr_min_factor=0.05, learning_rate=2e-4),
    dict(warmup_steps=0, learning_rate=1e-3),
])
def test_lr_schedule_equals_jax(fields):
    jcfg, tcfg = train_configs(**fields)
    ref = jax.jit(jstate.lr_schedule(jcfg.train))
    port = tstate.lr_schedule(tcfg.train)
    for step in (0, 1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 100):
        # f32 arithmetic in JAX's order; the cosines of two libraries may
        # differ by an ulp, which 1 + cos(pi * frac) can magnify a few times.
        assert port(step) == pytest.approx(float(ref(jnp.int32(step))),
                                           rel=1e-6, abs=0), step
    assert port(0) == pytest.approx(
        tcfg.train.learning_rate * (tcfg.train.warmup_factor
                                    if tcfg.train.warmup_steps else 1.0))


def test_ema_decay_equals_jax():
    jcfg, tcfg = train_configs(ema_decay=0.999)
    ref = jax.jit(lambda n: jstate.ema_decay_at(jcfg.train, n))
    for n in (0, 1, 5, 50, 10_000, 10 ** 6):
        assert tstate.ema_decay_at(tcfg.train, n) == float(ref(n))


# ------------------------------------------------------------ optimizer
@pytest.fixture(scope="module")
def flax_tree():
    """The tiny Deformable DETR's Flax params, every leaf redrawn N(0, 0.2)."""
    jm = JaxDeformableDETR(jconfig.tiny_deformable_detr_config())
    params = jax.jit(jm.init)(jax.random.key(0))["params"]
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda x: rng.normal(0, 0.2, x.shape).astype(np.float32), params)


def test_decay_mask_reads_the_flax_ndim(flax_tree):
    """``flax_param_ndims`` gives every port parameter its Flax leaf's
    ndim: the self-attention's query/key/value biases are 2-D in Flax
    (decayed), the deformable attention's value bias 1-D."""
    model = build_model(tconfig.tiny_deformable_detr_config(), device="cpu")
    filled = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, x.ndim, np.float32), flax_tree)
    want = {k: int(v.reshape(-1)[0])
            for k, v in from_flax_variables({"params": filled}).items()}
    assert flax_param_ndims(model.core) == want
    assert want["dec0.self_attn.query.bias"] == 2
    assert want["dec0.cross_attn.value.bias"] == 1
    assert model.core.dec0.self_attn.query.bias.ndim == 1


class LinearLossModel:
    """A stand-in model for ``make_train_step``: the tiny model's core with
    the loss ``sum_p <c_p, p>`` over the parameters that ``coeffs[i]`` (the
    i-th call's) names, so their gradients are the ``c_p`` and the others
    get none."""

    def __init__(self, core, coeffs):
        self.core, self.coeffs, self.calls = core, coeffs, 0
        self.device = torch.device("cpu")

    def train(self):
        pass

    def loss(self, batch, generator):
        del batch, generator
        c = self.coeffs[self.calls]
        self.calls += 1
        total = sum((c[n] * p).sum() for n, p in self.core.named_parameters()
                    if n in c)
        return total, {"loss": total.detach()}


@pytest.mark.parametrize("optimizer,clip", [("sgd", 1.0), ("adam", 1.0),
                                            ("adamw", 1.0), ("adamw", 0.0)])
def test_two_updates_equal_optax(flax_tree, optimizer, clip):
    fields = dict(optimizer=optimizer, learning_rate=1e-2, weight_decay=1e-3,
                  momentum=0.9, warmup_steps=4, backbone_lr_factor=0.1,
                  grad_clip_norm=clip, freeze=("class_head0",))
    jcfg, tcfg = train_configs(**fields)
    rng = np.random.default_rng(2)
    # Two steps of gradients in the Flax layout, of magnitude 0.5..1.5:
    # after clipping each stays above the coupled decay's wd * p, so no
    # element's Adam step divides a near-cancelled sum by itself. The first
    # conv of the backbone gets none in the port and zeros in JAX.
    no_grad = "backbone.Conv_0."
    grads_jax, coeffs = [], []
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda x: (rng.choice([-1.0, 1.0], x.shape)
                       * rng.uniform(0.5, 1.5, x.shape)).astype(np.float32),
            flax_tree)
        port = from_flax_variables({"params": g})
        coeffs.append({k: v for k, v in port.items()
                       if not k.startswith(no_grad)})
        g["backbone"]["Conv_0"] = jax.tree_util.tree_map(
            np.zeros_like, g["backbone"]["Conv_0"])
        grads_jax.append(g)

    tx = jstate.make_optimizer(jcfg.train)
    params = jax.tree_util.tree_map(jnp.asarray, flax_tree)
    opt_state = jax.jit(tx.init)(params)
    update = jax.jit(tx.update)
    norms = []
    for g in grads_jax:
        updates, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        masked = dict(g)
        masked["class_head0"] = jax.tree_util.tree_map(np.zeros_like,
                                                       g["class_head0"])
        norms.append(float(optax.global_norm(masked)))
    ref = from_flax_variables({"params": params})

    model = build_model(tcfg, device="cpu")
    model.core.load_state_dict(from_flax_variables({"params": flax_tree}))
    before = {k: v.detach().clone() for k, v in model.core.named_parameters()}
    stand_in = LinearLossModel(model.core, coeffs)
    state = tstate.create_train_state(model, tcfg.train, seed=None,
                                      device="cpu")
    step = make_train_step(stand_in, tcfg, device="cpu")
    for i in range(2):
        state, metrics = step(state, {"image": np.zeros((2, 1), np.float32)})
        assert float(metrics["grad_norm"]) == pytest.approx(norms[i], rel=1e-6)
        if clip:
            assert norms[i] > clip  # the clip triggers
    assert state.step == 2
    for name, p in model.core.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        if name.startswith("class_head0."):
            assert torch.equal(p, before[name])  # frozen: bit-identical
        elif name == no_grad + "weight":
            assert not torch.equal(p, before[name])  # decayed all the same


def test_freeze_prefix_must_match():
    model = build_model(tconfig.tiny_deformable_detr_config(), device="cpu")
    with pytest.raises(ValueError, match="matches no parameter"):
        tstate.freeze_mask(model.core, ("backbone/Conv_9",))
    mask = tstate.freeze_mask(model.core, ("dec1", "backbone/Conv_0"))
    assert mask["dec1.norm3.weight"] and mask["backbone.Conv_0.weight"]
    assert not mask["dec0.norm3.weight"]


def test_create_train_state():
    cfg = tconfig.tiny_deformable_detr_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, ema_decay=0.9))
    model = build_model(cfg, device="cpu").init(seed=3)
    kept = model.core.query_embed.detach().clone()
    state = tstate.create_train_state(model, cfg.train, seed=None,
                                      device="cpu")
    assert state.step == 0 and torch.equal(model.core.query_embed, kept)
    assert torch.equal(state.ema_params["query_embed"], kept)
    assert state.ema_params["query_embed"] is not model.core.query_embed
    redrawn = tstate.create_train_state(model, cfg.train, seed=4,
                                        device="cpu")
    assert not torch.equal(redrawn.params["query_embed"], kept)
    with pytest.raises(ValueError, match="ema_decay"):
        tstate.create_train_state(model, dataclasses.replace(
            cfg.train, ema_decay=1.0), device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        make_train_step(model, cfg)  # the default device is "cuda"


# ------------------------------------------------------- learning check
def test_loss_decreases_and_trains():
    """20 AdamW steps of deformable_detr_tiny on the JAX test's synthetic
    batch (as numpy): the last loss under 0.6x the first, as the JAX
    package's test requires of its own."""
    jcfg, tcfg = train_configs(optimizer="adamw", learning_rate=1e-3,
                               warmup_steps=0, grad_clip_norm=0.1,
                               weight_decay=1e-4)
    batch = {k: np.array(v) for k, v in jax_make_batch(jcfg).items()}
    model = build_model(tcfg, device="cpu")
    state = tstate.create_train_state(model, tcfg.train, seed=0, device="cpu")
    step = make_train_step(model, tcfg, device="cpu")
    losses = []
    for _ in range(20):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses[0]) and losses[0] < 40.0
    assert losses[-1] < 0.6 * losses[0], losses


@pytest.mark.parametrize("preset", ["cascade_tiny", "keypoint_tiny",
                                    "panoptic_tiny"])
def test_family_learning_checks_on_the_cpu(preset):
    """``chip_smoke.py``'s families_learning phase (the recipes of
    tests/test_cascade.py, test_keypoint.py and test_panoptic.py: SGD 0.02,
    no warmup, b=2, 20 steps on one synthetic batch) on the CPU's plain
    versions, at tpudet's bars (``chip_smoke.family_learning_verdict``)."""
    import chip_smoke

    cfg, rows = chip_smoke.family_learning_losses(preset, "cpu")
    assert len(rows) == chip_smoke.FAMILY_LEARNING["steps"] == 20
    ok, text = chip_smoke.family_learning_verdict(cfg, rows)
    print(f"{preset} learning on the CPU: {text}")
    assert ok, text
