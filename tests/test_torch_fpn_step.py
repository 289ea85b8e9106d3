"""FPN Faster R-CNN's train step in the PyTorch port against ``tpudet``'s,
on the CPU: three SGD updates of ``make_train_step`` equal to JAX's on
``tiny_test_config(use_fpn=True)`` with the windowed pooler at window 24
(small enough that the fit window moves RoIs up to p3..p5 on the 128-px
canvas, so the step pools and differentiates at several levels), and the
FPN learning check: ``tests/test_train.py::test_train_step_decreases_loss``'s
recipe (its synthetic batch, 25 SGD steps, no warmup, decay 1e-4) on the
FPN config with the windowed pooler at window 56, as coco_r101_fpn
trains, at learning rate 0.01, with JAX's sampler draws at every step
(``tests/test_torch_faster_rcnn_step.py::with_jax_draws``). At the C4
recipe's 0.02 tpudet's own tiny FPN run can diverge.

Tolerances (f32), those of the C4 step test: the loss and gradient norm of
each update within ``1e-5`` relative; each parameter within ``1e-4`` of
its largest change plus ``1e-6`` of the largest change anywhere plus
``1e-6`` of its value, outside the tiny backbone's conv biases: a
GroupNorm follows each, so their gradient is zero in exact arithmetic and
their three updates are rounding noise on both sides. Over 25 steps the
two runs part by rounding once a sampling decision flips: the first three
losses within ``1e-4`` relative, then both fall below
``FPN_LEARNING_RATIO``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_faster_rcnn import configs
from tests.test_torch_faster_rcnn_step import train_pair
from tests.test_train import make_train_batch, small_cfg
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.ops.roi_align import fpn_assign_levels as jax_levels
from tpudet_torch import config as tconfig
from tpudet_torch.models.import_weights import from_flax_variables
from tpudet_torch.ops.roi_align import fpn_assign_levels

torch.set_num_threads(2)

# The fall the FPN learning check requires, last loss over first. JAX's own
# run of this recipe falls to about 0.2x (as the test below prints it); its
# runs are not bitwise repeatable (XLA's multithreaded CPU sums) and a
# flipped sampling decision changes the trajectory, so the bound leaves
# room for that spread, as the C4 check's 0.5 does.
FPN_LEARNING_RATIO = 0.5


def preprocessed(jcfg, raw, seed):
    return {k: np.array(x) for k, x in jax_preprocess(
        jcfg, raw, jax.random.key(seed), training=False).items()}


def test_three_sgd_updates_equal_jax():
    fields = dict(learning_rate=0.02, warmup_steps=2, weight_decay=1e-3)
    jcfg, tcfg = configs("tiny", backbone=dict(use_fpn=True),
                         roi=dict(pooler="roi_align_window", window=24),
                         train=fields)
    (jstep, jst), (tstep, tst), calls = train_pair(jcfg, tcfg, seed=21)
    batch = preprocessed(jcfg, {k: np.array(x) for k, x in
                                make_train_batch(jcfg).items()}, 0)
    # The ground truth, always among the sampled RoIs, sits at several
    # levels under the window.
    gt = torch.from_numpy(batch["gt_boxes"])[torch.from_numpy(
        batch["gt_valid"])]
    levels = fpn_assign_levels(gt, fit_window=24)
    np.testing.assert_array_equal(
        levels.numpy(), np.asarray(jax.jit(lambda b: jax_levels(
            b, fit_window=24))(gt.numpy())))
    assert len(torch.unique(levels)) >= 2
    before = {k: p.detach().clone() for k, p in tst.params.items()}
    for i in range(3):
        jst, jmetrics = jstep(jst, batch)
        tst, tmetrics = tstep(tst, batch)
        for k in ("loss", "grad_norm", "num_fg_rois"):
            assert float(tmetrics[k]) == pytest.approx(
                float(jmetrics[k]), rel=1e-5), (i, k)
    assert len(calls) == 3 and tst.step == 3
    ref = from_flax_variables({"params": jst.params})
    moves = {k: (ref[k] - before[k]).numpy() for k in ref}
    floor = 1e-6 * max(np.abs(m).max() for m in moves.values())
    for name, p in tst.params.items():
        if name.startswith("backbone.Conv_") and name.endswith(".bias"):
            continue  # rounding noise: a GroupNorm follows
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-6,
                                   atol=1e-4 * np.abs(moves[name]).max() + floor,
                                   err_msg=name)


def test_tiny_fpn_learning_check_tracks_jax():
    """The JAX package's learning-check recipe on the FPN config with the
    windowed pooler (window 56), run in both packages from the same weights
    with the same draws: the port's losses follow JAX's and fall as far."""
    jcfg = small_cfg(learning_rate=0.01)
    jcfg = jcfg.replace(
        backbone=dataclasses.replace(jcfg.backbone, use_fpn=True),
        roi=dataclasses.replace(jcfg.roi, pooler="roi_align_window",
                                window=56))
    tcfg = tconfig.tiny_test_config(use_fpn=True)
    tcfg = tcfg.replace(
        roi=dataclasses.replace(tcfg.roi, pooler="roi_align_window",
                                window=56),
        train=tconfig.TrainConfig(
            **{f.name: getattr(jcfg.train, f.name)
               for f in dataclasses.fields(tconfig.TrainConfig)}))
    (jstep, jst), (tstep, tst), _ = train_pair(jcfg, tcfg)
    batch = preprocessed(jcfg, make_train_batch(jcfg), 42)
    ref, port = [], []
    for _ in range(25):
        jst, jm = jstep(jst, batch)
        tst, tm = tstep(tst, batch)
        ref.append(float(jm["loss"]))
        port.append(float(tm["loss"]))
    np.testing.assert_allclose(port[:3], ref[:3], rtol=1e-4)
    print(f"tiny FPN learning check, 25 SGD steps: JAX {ref[0]:.4f} -> "
          f"{ref[-1]:.4f} ({ref[-1] / ref[0]:.4f}x), port {port[0]:.4f} -> "
          f"{port[-1]:.4f} ({port[-1] / port[0]:.4f}x)")
    assert ref[-1] < FPN_LEARNING_RATIO * ref[0], ref
    assert port[-1] < FPN_LEARNING_RATIO * port[0], port
