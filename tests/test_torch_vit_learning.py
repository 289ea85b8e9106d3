"""The tiny ViTDet learning check on the CPU: ``chip_smoke``'s recipe for
``vitdet_tiny`` (``family_learning_losses``: SGD 0.02, no warmup, 20 steps
on one synthetic batch of 2) run by tpudet's own train step from keys 0-1
and by the port's from seeds 0-1. Each fall (the last loss over the
first) must lie under ``chip_smoke.VITDET_LEARNING_RATIO``, the card's bar;
the falls are printed (tpudet's 0.52 and 0.52, the port's 0.59 and 0.50 on this
recipe). A file of its own: the port's CPU steps take ~0.9 s each.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpudet import config as jconfig
from tpudet.data.preprocess import device_preprocess as jax_preprocess
from tpudet.models import build_model as jax_build

torch.set_num_threads(2)


def test_tiny_learning_check():
    """``chip_smoke.family_learning_losses``' recipe (SGD 0.02, no warmup,
    20 steps on one synthetic batch of 2): tpudet's own train step from
    keys 0-1 and the port's from seeds 0-1, each fall under the card's
    bar."""
    from tests.test_torch_faster_rcnn_step import jax_state
    from tpudet.data import DataLoader, SyntheticDataset
    from tpudet.train.step import make_train_step

    steps = chip_smoke.FAMILY_LEARNING["steps"]
    bar = chip_smoke.VITDET_LEARNING_RATIO
    jcfg = jconfig.tiny_vitdet_config()
    jcfg = jcfg.replace(train=dataclasses.replace(
        jcfg.train, learning_rate=chip_smoke.FAMILY_LEARNING["lr"],
        warmup_steps=0, batch_size=2))
    ds = SyntheticDataset(num_classes=jcfg.data.num_classes, num_examples=2,
                          image_size=jcfg.data.canvas_height, seed=0)
    raw = next(iter(DataLoader(jcfg, ds, 2, shuffle=False,
                               num_workers=1).batches(0)))
    batch = jax_preprocess(jcfg, {k: jnp.asarray(x) for k, x in raw.items()},
                           jax.random.key(0), training=False)
    jm = jax_build(jcfg)
    step = make_train_step(jm, jcfg)
    falls = {}
    for key in range(2):
        key = jax.random.key(key)
        state = jax_state(jm, jcfg, jax.jit(jm.init)(key), key)
        losses = []
        for _ in range(steps):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        falls[f"tpudet key {len(falls)}"] = losses[-1] / losses[0]
    from tpudet_torch.train import state as tstate

    create = tstate.create_train_state
    for seed in range(2):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tstate, "create_train_state",
                       lambda m, c, seed=0, device="cuda", _s=seed:
                       create(m, c, seed=_s, device=device))
            _, rows = chip_smoke.family_learning_losses("vitdet_tiny",
                                                        device="cpu")
        losses = [r["loss"] for r in rows]
        assert np.isfinite(losses).all()
        falls[f"port seed {seed}"] = losses[-1] / losses[0]
    print(falls)
    assert all(f < bar for f in falls.values()), falls
