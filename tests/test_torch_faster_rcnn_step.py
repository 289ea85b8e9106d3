"""Faster R-CNN's train step in the PyTorch port against ``tpudet``'s, on
the CPU: one SGD update of ``make_train_step`` equal to JAX's, the
``det_only`` freeze check, and the learning check of
``tests/test_train.py::test_train_step_decreases_loss`` (the same config,
batch and weights, 25 SGD steps) with JAX's sampler draws at every step.

JAX's step draws from ``fold_in(state.rng, step)`` (then ``FasterRCNN.loss``'s
chain, rebuilt by ``test_torch_faster_rcnn_train.jax_draws``); the port's
model gets those draws in place of its generator's.

Tolerances (f32): after one update each parameter within ``1e-4`` of its
largest change plus ``1e-6`` of the largest change anywhere (the
gradients' tolerance, times the learning rate) plus ``1e-6`` of its value
(the rounding of the updated parameter); the loss and gradient norm within
``1e-5`` relative. Over 25 steps the two runs drift apart by
rounding once a sampling decision flips (from step 3 on in this run): the
first three losses within ``1e-4`` relative, then both falls below
``LEARNING_RATIO``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_faster_rcnn import configs, pair
from tests.test_torch_faster_rcnn_train import jax_draws
from tests.test_train import make_train_batch, small_cfg
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.models import FasterRCNN as JaxFasterRCNN
from tpudet.train import state as jstate
from tpudet.train.step import make_train_step as jax_train_step
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.train.state import create_train_state
from tpudet_torch.train.step import make_train_step

torch.set_num_threads(2)

# The fall the tiny learning check requires, last loss over first. JAX's own
# test falls to about 0.4x here, and its runs are not bitwise repeatable
# (XLA's multithreaded CPU sums), which a flipped sampling decision turns
# into a different trajectory: the bound leaves room for that spread.
# chip_smoke.py holds the card to it.
LEARNING_RATIO = 0.5


def jax_state(jm, jcfg, variables, rng):
    """JAX's ``TrainState`` around ``variables``, built as
    ``create_train_state`` builds it (with jitted pieces)."""
    tx = jstate.make_optimizer(jcfg.train)
    params = variables["params"]
    return jstate.TrainState(
        step=jax.numpy.zeros((), jax.numpy.int32), params=params,
        constants={k: x for k, x in variables.items() if k != "params"},
        opt_state=jax.jit(tx.init)(params), rng=rng)


def with_jax_draws(tm, rng):
    """Make the port model's ``loss`` take, at its n-th call, the draws of
    JAX's n-th step (``fold_in(rng, n)``), ignoring the step's draws; the
    generators the step draws from are recorded."""
    original, original_draw, calls = tm.loss, tm.draw_samples, []

    def draw_samples(generator, b, canvas_hw):
        calls.append(generator)
        return original_draw(generator, b, canvas_hw)

    def loss(batch, generator=None, draws=None):
        shapes = tm.draw_shapes(batch["image"].shape[0],
                                batch["image"].shape[1:3])
        step_rng = jax.random.fold_in(rng, len(calls) - 1)
        return original(batch, draws=jax_draws(
            step_rng, shapes["rpn"][0], shapes["rpn"][1], shapes["roi"][1]))

    tm.draw_samples, tm.loss = draw_samples, loss
    return calls


def train_pair(jcfg, tcfg, seed=None):
    """JAX's jitted step and state, and the port's step and state, from the
    same weights: ``test_torch_faster_rcnn.pair``'s for a ``seed``, else
    those of JAX's ``create_train_state(model, cfg.train, key(0))``."""
    if seed is None:
        rng_init, rng = jax.random.split(jax.random.key(0))
        jm = JaxFasterRCNN(jcfg)
        v = jax.jit(jm.init)(rng_init)
        tm = build_model(tcfg, device="cpu")
        tm.core.load_state_dict(from_flax_variables(v))
    else:
        jm, v, tm = pair(jcfg, tcfg, seed=seed)
        rng = jax.random.key(seed + 100)
    # The jitted step donates its state, rng included: the port keeps a copy.
    state = jax_state(jm, jcfg, v, jax.random.wrap_key_data(
        jax.numpy.array(jax.random.key_data(rng))))
    tstate = create_train_state(tm, tcfg.train, seed=None, device="cpu")
    calls = with_jax_draws(tm, rng)
    return (jax_train_step(jm, jcfg), state), (
        make_train_step(tm, tcfg, device="cpu"), tstate), calls


def test_det_only_requires_a_frozen_rpn():
    cfg = tconfig.tiny_test_config().replace(det_only=True)
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="rpn_head"):
        make_train_step(model, cfg, device="cpu")
    frozen = cfg.replace(train=dataclasses.replace(cfg.train,
                                                   freeze=("rpn_head",)))
    make_train_step(model, frozen, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_model(cfg.replace(rpn_only=True), device="cpu").loss(
            {"image": torch.zeros(1, 128, 128, 3)})


def test_one_sgd_update_equals_jax():
    fields = dict(learning_rate=0.02, warmup_steps=2, weight_decay=1e-3)
    jcfg, tcfg = configs("tiny", train=fields)
    (jstep, jst), (tstep, tst), calls = train_pair(jcfg, tcfg, seed=21)
    batch = {k: np.array(x) for k, x in make_train_batch(jcfg).items()}
    batch = {k: np.array(x) for k, x in jax_preprocess(
        jcfg, batch, jax.random.key(0), training=False).items()}
    before = {k: p.detach().clone() for k, p in tst.params.items()}
    jst, jmetrics = jstep(jst, batch)
    tst, tmetrics = tstep(tst, batch)
    assert len(calls) == 1 and isinstance(calls[0], torch.Generator)
    for k in ("loss", "grad_norm", "num_fg_rois"):
        assert float(tmetrics[k]) == pytest.approx(float(jmetrics[k]),
                                                   rel=1e-5), k
    ref = from_flax_variables({"params": jst.params})
    moves = {k: (ref[k] - before[k]).numpy() for k in ref}
    floor = 1e-6 * max(np.abs(m).max() for m in moves.values())
    for name, p in tst.params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-6,
                                   atol=1e-4 * np.abs(moves[name]).max() + floor,
                                   err_msg=name)
    assert tst.step == 1


def test_tiny_learning_check_tracks_jax():
    """``test_train_step_decreases_loss`` of the JAX package (small_cfg:
    SGD 0.02, no warmup, decay 1e-4; its initial state and synthetic batch;
    25 steps), run in both packages from the same weights with the same
    draws: the port's losses follow JAX's and fall as far."""
    jcfg = small_cfg()
    tcfg = tconfig.tiny_test_config().replace(train=tconfig.TrainConfig(
        **{f.name: getattr(jcfg.train, f.name)
           for f in dataclasses.fields(tconfig.TrainConfig)}))
    (jstep, jst), (tstep, tst), _ = train_pair(jcfg, tcfg)
    raw = make_train_batch(jcfg)
    batch = {k: np.array(x) for k, x in jax_preprocess(
        jcfg, raw, jax.random.key(42), training=False).items()}
    ref, port = [], []
    for _ in range(25):
        jst, jm = jstep(jst, batch)
        tst, tm = tstep(tst, batch)
        ref.append(float(jm["loss"]))
        port.append(float(tm["loss"]))
    # Until a sampling decision flips (a proposal's IoU or a top-k order
    # crosses a tie), the two runs are the same computation.
    np.testing.assert_allclose(port[:3], ref[:3], rtol=1e-4)
    # Then each follows its own samples. Both must fall as JAX's test
    # needs (last < first) and below LEARNING_RATIO of the first.
    print(f"tiny learning check, 25 SGD steps: JAX {ref[0]:.4f} -> "
          f"{ref[-1]:.4f} ({ref[-1] / ref[0]:.3f}x), port {port[0]:.4f} -> "
          f"{port[-1]:.4f} ({port[-1] / port[0]:.3f}x)")
    assert ref[-1] < LEARNING_RATIO * ref[0], ref
    assert port[-1] < LEARNING_RATIO * port[0], port
