"""Helpers of the port's tensor-parallel tests: spawn a gloo mesh of
``tests/_torch_tp_worker.py`` processes, and hold each rank's shards
against the one-process step's whole tensors and against tpudet's own
sharded step on the same weights, draws and batch."""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import free_port, spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_mesh(out, world, model, families, ckpt="", start=None):
    """``world`` worker processes on a mesh with a model axis of ``model``,
    each family from ``start``'s weights and draws where it holds them
    (``tpudet_start``) -> each global rank's record."""
    init = f"tcp://127.0.0.1:{free_port()}"
    path = ""
    if start:
        path = os.path.join(out, "start.pt")
        torch.save(start, path)
    spawn([[sys.executable, os.path.join(ROOT, "tests", "_torch_tp_worker.py"),
            "--rank", str(r), "--world", str(world), "--model", str(model),
            "--init", init, "--out", str(out), "--families", families,
            "--ckpt", str(ckpt), "--start", path] for r in range(world)])
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def shard_of(full, shard, rank, size):
    """This model rank's block of the whole tensor ``full``."""
    if shard.dim is None:
        return full
    step = full.shape[shard.dim] // size
    return full.narrow(shard.dim, rank * step, step)


def assert_shards_equal(got, want, layout, rank, size, label):
    """Each of ``got`` (a rank's shards by name) equals its block of
    ``want`` (whole tensors) within 1e-6 of the tensor's largest magnitude,
    floored at 1e-6 of the largest of all (the tensors that are zero in
    exact arithmetic, such as a conv bias before a GroupNorm)."""
    assert set(got) == set(want), (label, set(got) ^ set(want))
    floor = 1e-6 * max(float(t.abs().max()) for t in want.values())
    for k, full in want.items():
        exp = shard_of(full, layout[k], rank, size)
        assert got[k].shape == exp.shape, (label, k)
        torch.testing.assert_close(
            got[k], exp, rtol=0, atol=1e-6 * float(exp.abs().max()) + floor,
            msg=f"{label} {k}")


def port_config(name):
    """The port's config of a family the TP tests step (``"mesh"``: the
    dp=2 x tp=2 step's)."""
    from tests import _torch_tp_worker as worker

    if name == "mesh":
        return worker.mesh_config()
    return worker.family_configs()[name]


def tpudet_config(name):
    """tpudet's config of the same fields as ``port_config(name)``."""
    from tests import _torch_tp_worker as worker
    from tpudet import config as jc

    return {"faster_rcnn": jc.tiny_test_config,
            "fpn": lambda: jc.tiny_test_config(use_fpn=True),
            "cascade": jc.tiny_cascade_config,
            "detr_no_dropout": jc.tiny_detr_config,
            "deformable_detr": jc.tiny_deformable_detr_config,
            "vitdet": jc.tiny_vitdet_config,
            "mesh": lambda: jc.apply_overrides(jc.tiny_test_config(),
                                               worker.MESH_FIELDS)}[name]()


def tpudet_steps(name, num_data, num_model, steps=1):
    """tpudet's own sharded steps, as its ``tests/test_train.py`` takes
    them: ``create_train_state`` from ``key(0)``, ``shard_train_state`` on
    a ``num_data`` x ``num_model`` mesh of the forced host devices, and
    ``steps`` calls of ``make_train_step(mesh=)`` on the global batch of
    ``_torch_dp_worker`` -> (the port's start: the initial weights and
    each step's sampler draws per microbatch, ``jax_draws`` of the step's
    ``fold_in`` keys; per step: the metrics and the whole gradients,
    parameters, momentum and EMA after it, in the port's names through
    ``from_flax_variables``). The gradient is the SGD trace less the
    previous trace's momentum and the coupled decay of the ndim >= 2
    leaves (``tpudet.train.state.make_optimizer``)."""
    import jax
    import jax.numpy as jnp
    import optax

    from tests import _torch_dp_worker as dpw
    from tests.test_torch_faster_rcnn_train import jax_draws
    from tpudet.models import build_model as jax_build_model
    from tpudet.parallel.mesh import make_mesh, shard_batch
    from tpudet.parallel.sharding_rules import shard_train_state
    from tpudet.train.state import create_train_state
    from tpudet.train.step import make_train_step
    from tpudet_torch.models import build_model
    from tpudet_torch.models.import_weights import from_flax_variables

    jcfg, tcfg = tpudet_config(name), port_config(name)
    assert jcfg.train.optimizer == "sgd" and jcfg.train.weight_decay > 0
    jm = jax_build_model(jcfg)
    state = create_train_state(jm, jcfg.train, jax.random.key(0))
    # The jitted step donates its state, rng included: keep a copy.
    rng = jax.random.wrap_key_data(jnp.array(jax.random.key_data(state.rng)))
    batch = dpw.global_batch(tcfg, seed=5)
    accum = max(1, jcfg.train.accum_steps)
    b = batch["image"].shape[0] // accum
    draws = []
    tm = build_model(tcfg, device="cpu")
    if hasattr(tm, "draw_shapes"):
        shapes = tm.draw_shapes(b, batch["image"].shape[1:3])
        for s in range(steps):
            key = jax.random.fold_in(rng, s)
            draws.append([jax_draws(key if accum == 1
                                    else jax.random.fold_in(key, a), b,
                                    shapes["rpn"][1], shapes["roi"][1])
                          for a in range(accum)])
    start = {"weights": from_flax_variables(
        {"params": state.params, **state.constants}), "draws": draws}

    def port(tree):
        return from_flax_variables({"params": tree})

    mesh = make_mesh(num_data=num_data, num_model=num_model)
    state = shard_train_state(mesh, state)
    step = make_train_step(jm, jcfg, mesh=mesh, state_example=state)
    placed = shard_batch(mesh, batch)
    params = jax.device_get(state.params)
    trace = jax.tree.map(np.zeros_like, params)
    wd, momentum = jcfg.train.weight_decay, jcfg.train.momentum
    out = []
    for _ in range(steps):
        state, metrics = step(state, placed)
        new_params = jax.device_get(state.params)
        new_trace = jax.device_get(
            optax.tree_utils.tree_get(state.opt_state, "trace"))
        grads = jax.tree.map(
            lambda t, prev, p: t - momentum * prev - (wd * p if p.ndim >= 2
                                                      else 0.0),
            new_trace, trace, params)
        out.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": port(grads), "params": port(new_params),
            "momentum": port(new_trace),
            "ema": (None if state.ema_params is None else
                    port(jax.device_get(state.ema_params)))})
        params, trace = new_params, new_trace
    return start, out


@contextlib.contextmanager
def groupnorm_in_f64():
    """Inside: ``F.group_norm`` computes in float64 and rounds its output
    to its input's dtype. torch's f32 CPU GroupNorm loses precision as a
    group's mean grows beside its spread (a group at 300:1: 7e-6 relative
    forward, 3e-6 backward, against 1e-7 centred): on the TP tests' batch
    the tiny GN backbone's first layers' gradients sit up to 6e-3 of their
    largest from tpudet's, and the same step with this float64 GroupNorm
    within 0.11 of the step tests' tolerance (measured for every
    family)."""
    import torch.nn.functional as F

    real = F.group_norm

    def group_norm(x, groups, weight=None, bias=None, eps=1e-5):
        wide = [None if t is None else t.double() for t in (weight, bias)]
        return real(x.double(), groups, *wide, eps).to(x.dtype)

    F.group_norm = group_norm
    try:
        yield
    finally:
        F.group_norm = real


def f32_rounding(plain, wide):
    """Per record key (grads, momentum, params) and tensor: the largest
    distance of the one-process step ``plain`` from the same step with
    GroupNorm in float64 (``wide``): the port's own f32 rounding there."""
    def momentum(rec):
        return {k: e["momentum_buffer"] for k, e in rec["optimizer"].items()}

    return {"grads": {k: float((g - wide["grads"][k]).abs().max())
                      for k, g in plain["grads"].items()},
            "momentum": {k: float((m - momentum(wide)[k]).abs().max())
                         for k, m in momentum(plain).items()},
            "params": {k: float((p - wide["params"][k]).abs().max())
                       for k, p in plain["params"].items()}}


def assert_shards_match_tpudet(got, want, layout, rank, size, label,
                               base=None, slack=None):
    """Each of ``got`` (a rank's shards by name) against its block of
    ``want`` (tpudet's whole tensors in the port's names) within the
    port-vs-tpudet step tests' tolerances: gradients and momentum within
    1e-5 relative plus 1e-4 of the tensor's largest and 1e-6 of the
    largest anywhere (``test_torch_cascade.py``); with ``base`` (the whole
    tensors before the step), parameters and EMA within 1e-6 relative plus
    1e-4 of the tensor's largest move and 1e-6 of the largest move
    anywhere (``test_torch_faster_rcnn_step.py``). ``slack`` adds 4x the
    port's own f32 GroupNorm rounding of each tensor (``f32_rounding``),
    as the card is held within 4x the CPU's own spread."""
    assert set(got) == set(want), (label, set(got) ^ set(want))
    ref = want if base is None else {k: want[k] - base[k] for k in want}
    floor = 1e-6 * max(float(t.abs().max()) for t in ref.values())
    for k, full in want.items():
        exp = shard_of(full, layout[k], rank, size)
        assert got[k].shape == exp.shape, (label, k)
        torch.testing.assert_close(
            got[k], exp, rtol=1e-5 if base is None else 1e-6,
            atol=(1e-4 * float(ref[k].abs().max()) + floor
                  + 4 * (slack or {}).get(k, 0.0)),
            msg=f"{label} {k}")


def assert_step_matches_tpudet(got, want, before, layout, rank, size,
                               label, slack=None):
    """One rank's step record ``got`` (``_torch_tp_worker.step_once``)
    against tpudet's sharded step ``want`` (``tpudet_steps``), from the
    whole parameters ``before`` it: the metrics within 1e-5 relative (the
    gradient norm 1e-4), each gradient, momentum and parameter shard by
    ``assert_shards_match_tpudet`` (``slack``: ``f32_rounding``'s)."""
    assert set(got["metrics"]) == set(want["metrics"]), label
    for k, v in want["metrics"].items():
        rel = 1e-4 if k == "grad_norm" else 1e-5
        assert got["metrics"][k] == pytest.approx(v, rel=rel), (label, k)
    momentum = {k: e["momentum_buffer"] for k, e in got["optimizer"].items()}
    for what, mine, base in (("grads", got["grads"], None),
                             ("momentum", momentum, None),
                             ("params", got["params"], before)):
        assert_shards_match_tpudet(mine, want[what], layout, rank, size,
                                   f"{label} {what}", base,
                                   (slack or {}).get(what))
