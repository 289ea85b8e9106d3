"""Three ``make_train_step`` updates of the tiny Deformable DETR in the
PyTorch port against the JAX package's jitted step, on the CPU, from the
same weights (``test_torch_deformable_detr_predict.widened``) and batches:
SGD with momentum, coupled weight decay, warmup, clipping, a backbone
factor of 0.1 and an EMA, one microbatch. ``test_torch_train_accum.py``
runs two microbatches under AdamW.

Tolerances (f32): each step's loss within ``1e-5`` relative and its
gradient norm within ``1e-4``; each parameter and EMA entry after three
updates within ``1e-5`` relative and ``1e-6`` absolute, on parameters of
order 0.01 to 1 (SGD moves a parameter by the learning rate times a
gradient that agrees within ~1e-5; a zero-initialized bias whose gradient
is zero in exact arithmetic stays near 1e-11 on both sides).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_deformable_detr_predict import widened
from tests.test_torch_deformable_detr_train import train_batch
from tpudet import config as jconfig
from tpudet.models import DeformableDETR as JaxDeformableDETR
from tpudet.train import state as jstate
from tpudet.train.step import make_train_step as jax_make_train_step
from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.train.state import create_train_state
from tpudet_torch.train.step import make_train_step

torch.set_num_threads(2)


def run_both(steps=3, **fields):
    """``steps`` updates in both packages from the same widened weights,
    each on its own batch -> (JAX metrics, port metrics, the initial
    parameters and JAX's final parameters and EMA in the port's layout, the
    port's state)."""
    jcfg, tcfg = [mod.tiny_deformable_detr_config() for mod in (jconfig,
                                                                tconfig)]
    jcfg, tcfg = [c.replace(train=dataclasses.replace(c.train, **fields))
                  for c in (jcfg, tcfg)]
    jm = JaxDeformableDETR(jcfg)
    v = widened(jax.jit(jm.init)(jax.random.key(7)), 7,
                jcfg.deformable_detr.d_model)
    batches = [train_batch(tcfg, seed=s) for s in range(steps)]

    tx = jstate.make_optimizer(jcfg.train)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, constants={},
        opt_state=jax.jit(tx.init)(params), rng=jax.random.key(0),
        ema_params=(jax.tree_util.tree_map(jnp.copy, params)
                    if jcfg.train.ema_decay > 0 else None))
    jstep = jax_make_train_step(jm, jcfg)
    ref = []
    for batch in batches:
        state, metrics = jstep(state, batch)
        ref.append({k: float(x) for k, x in metrics.items()})
    ref_params = from_flax_variables({"params": state.params})
    ref_ema = (from_flax_variables({"params": state.ema_params})
               if state.ema_params is not None else None)

    model = build_model(tcfg, device="cpu")
    model.core.load_state_dict(from_flax_variables(v))
    tstate = create_train_state(model, tcfg.train, seed=None, device="cpu")
    step = make_train_step(model, tcfg, device="cpu")
    out = []
    # The backward of an indexed gather (the plain deformable attention's)
    # accumulates on the CPU in an order that depends on thread scheduling.
    # AdamW turns that rounding into lr-sized moves of near-zero gradient
    # elements, which moved the next step's grad_norm by ~1e-4 from run to
    # run; PyTorch's deterministic algorithms fix the order.
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for batch in batches:
            tstate, metrics = step(tstate, batch)
            out.append({k: float(x) for k, x in metrics.items()})
    finally:
        torch.use_deterministic_algorithms(deterministic)
    return ref, out, (from_flax_variables(v), ref_params, ref_ema), tstate


def assert_metrics_equal(ref, out):
    assert [set(m) for m in out] == [set(m) for m in ref]
    for r, o in zip(ref, out):
        for k in r:
            rel = 1e-4 if k == "grad_norm" else 1e-5
            assert o[k] == pytest.approx(r[k], rel=rel), k


def test_three_sgd_steps_with_ema_equal_jax():
    ref, out, (_, ref_params, ref_ema), state = run_both(
        optimizer="sgd", learning_rate=1e-2, momentum=0.9, weight_decay=1e-4,
        warmup_steps=2, grad_clip_norm=1.0, backbone_lr_factor=0.1,
        ema_decay=0.9)
    assert_metrics_equal(ref, out)
    assert all(m["grad_norm"] > 1.0 for m in ref)  # the clip triggers
    assert state.step == 3
    for name, p in state.params.items():
        for got, want in ((p.detach(), ref_params[name]),
                          (state.ema_params[name], ref_ema[name])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
