"""Worker process of the port's tensor-parallel tests
(``tests/test_torch_tensor_parallel*.py``): one rank of a gloo
("data", "model") mesh of the PyTorch port on the CPU (no JAX).

``--families a,b``: on a ``--world``-process mesh with a model axis of
``--model``, one ``make_train_step`` step of each family's tiny config on
this process's rows of the global batch of ``tests/_torch_dp_worker.py``,
from the weights and with the sampler draws that ``--start`` holds for
the family (tpudet's own initial state and step draws, converted by the
test), else from the seed-0 state with the port's draws. It writes each step's
metrics, this rank's gradient, updated parameter and momentum shards and
the layout.

``--families mesh``: the counterpart of ``__graft_entry__.dryrun_multichip``
on a dp=2 x tp=2 mesh: a tiny Faster R-CNN step with two accumulated
microbatches and the EMA on (from ``--start``'s weights and draws, as
above), a checkpoint saved from the sharded state
(the model peers of data rank 0 join, rank 0 writes), restored into the
same layout, and one more step. The test restores the same checkpoint into
dp=4 x tp=1 (``--families restore``; one row per rank, no second step of
two microbatches) and into one process.

It writes what it saw to ``<out>/rank<r>.pt``; a failed assertion exits
non-zero, which fails the test.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def family_configs():
    """The tiny config of each family the TP tests step. DETR keeps its
    preset's dropout of 0.1: the FFN's mask must be drawn at full width."""
    from tpudet_torch.config import (
        apply_overrides,
        tiny_cascade_config,
        tiny_deformable_detr_config,
        tiny_detr_config,
        tiny_test_config,
        tiny_vitdet_config,
    )

    return {
        "faster_rcnn": tiny_test_config(),
        "fpn": tiny_test_config(use_fpn=True),
        "cascade": tiny_cascade_config(),
        "detr": apply_overrides(tiny_detr_config(), {"detr.dropout": 0.1}),
        # tpudet's dropout masks come from its own generator: its step is
        # compared at the tiny config's dropout of 0.
        "detr_no_dropout": tiny_detr_config(),
        "deformable_detr": tiny_deformable_detr_config(),
        "vitdet": tiny_vitdet_config(),
    }


# The dp=2 x tp=2 step's fields (the global batch of ``_torch_dp_worker``:
# tpudet's mesh step wants each microbatch divisible by the data axis).
MESH_FIELDS = {"train.accum_steps": 2, "train.ema_decay": 0.9,
               "train.batch_size": 4}


def mesh_config():
    """The dp=2 x tp=2 step's config: tiny Faster R-CNN, two accumulated
    microbatches, the EMA on."""
    from tpudet_torch.config import apply_overrides, tiny_test_config

    return apply_overrides(tiny_test_config(), MESH_FIELDS)


def rows(dp, accum):
    """This process's rows of the global batch of ``_torch_dp_worker``."""
    from tests import _torch_dp_worker as dpw
    from tpudet_torch.data.loader import process_rows

    if dp is None:
        return slice(None)
    return process_rows(dpw.GLOBAL_BATCH, dp.rank, dp.world_size, accum)


def use_draws(model, draws):
    """Have ``model``'s samplers take ``draws`` (one entry per microbatch,
    in the order the steps draw them) in place of its generator's."""
    queue = list(draws)

    def draw_samples(generator, b, canvas_hw=None):
        return queue.pop(0)

    model.draw_samples = draw_samples


def step_once(cfg, dp, state=None, init=None, index=0):
    """Step ``index`` of a run, on this process's rows of the global batch
    (seed 5), from ``state``, or from ``init["weights"]`` (None: the
    seed-0 state); the samplers take ``init["draws"][index]`` (one entry
    per microbatch) where given -> (state, record)."""
    from tests import _torch_dp_worker as dpw
    from tpudet_torch.models import build_model
    from tpudet_torch.train.state import create_train_state
    from tpudet_torch.train.step import make_train_step

    if state is None:
        model = build_model(cfg, device="cpu")
        if init is not None:
            model.core.load_state_dict(init["weights"])
        state = create_train_state(model, cfg.train,
                                   seed=0 if init is None else None,
                                   device="cpu", dp=dp)
    if init is not None and init["draws"]:
        use_draws(state.model, init["draws"][index])
    batch = {k: torch.from_numpy(v[rows(dp, cfg.train.accum_steps)])
             for k, v in dpw.global_batch(cfg, seed=5).items()}
    step = make_train_step(state.model, cfg, device="cpu", dp=dp)
    state, metrics = step(state, batch)
    return state, {"metrics": {k: float(v) for k, v in metrics.items()},
                   "grads": {k: p.grad.detach().clone()
                             for k, p in state.params.items()
                             if p.grad is not None},
                   **saved(state)}


def saved(state):
    """The state's parameters, EMA and optimizer state (by parameter
    name), copied."""
    from tpudet_torch.train.checkpoint import param_names

    names = param_names(state)
    return {
        "params": {k: p.detach().clone() for k, p in state.params.items()},
        "ema": (None if state.ema_params is None else
                {k: v.detach().clone() for k, v in state.ema_params.items()}),
        "optimizer": {names[int(k)]: {n: v.clone() for n, v in entry.items()
                                      if isinstance(v, torch.Tensor)}
                      for k, entry in
                      state.optimizer.state_dict()["state"].items()}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--model", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--families", required=True)
    ap.add_argument("--ckpt", default="", help="the checkpoint directory "
                    "that --families restore reads")
    ap.add_argument("--start", default="", help="a torch file: per family, "
                    "the initial weights and each step's sampler draws")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from tpudet_torch.models import build_model
    from tpudet_torch.parallel import init_mesh
    from tpudet_torch.parallel.sharding_rules import tp_layout
    from tpudet_torch.train.checkpoint import CheckpointManager
    from tpudet_torch.train.state import create_train_state

    dp = init_mesh(args.model, -1, "cpu", rank=args.rank,
                   world_size=args.world, init_method=args.init, timeout_s=90)
    result = {"rank": dp.rank, "model_rank": dp.model_rank,
              "model_size": dp.model_size, "global_rank": dp.global_rank}
    ckpt_dir = os.path.join(args.out, "ckpt")
    start = torch.load(args.start) if args.start else {}
    if args.families == "mesh":
        cfg = mesh_config()
        init = start.get("mesh")
        state, result["step1"] = step_once(cfg, dp, init=init)
        result["layout"] = state.model.core.tp.layout
        if dp.rank == 0:
            CheckpointManager(ckpt_dir).save(state)
        dp.barrier()
        fresh = create_train_state(build_model(cfg, device="cpu"), cfg.train,
                                   seed=123, device="cpu", dp=dp)
        restored = CheckpointManager(ckpt_dir).restore(fresh)
        result["restored_step"] = restored.step
        result["restored"] = {k: p.detach().clone()
                              for k, p in restored.params.items()}
        result["restored_ema"] = {k: v.clone()
                                  for k, v in restored.ema_params.items()}
        result["restored_optimizer"] = saved(restored)["optimizer"]
        _, result["step2"] = step_once(cfg, dp, restored, init=init, index=1)
    elif args.families == "restore":
        cfg = mesh_config()
        fresh = create_train_state(build_model(cfg, device="cpu"), cfg.train,
                                   seed=123, device="cpu", dp=dp)
        restored = CheckpointManager(args.ckpt).restore(fresh)
        result["restored_step"] = restored.step
        result["restored"] = {k: p.detach().clone()
                              for k, p in restored.params.items()}
    else:
        configs = family_configs()
        for name in args.families.split(","):
            cfg = configs[name]
            state, result[name] = step_once(cfg, dp, init=start.get(name))
            result[name]["layout"] = tp_layout(state.model, dp.model_size)
    torch.save(result, os.path.join(args.out, f"rank{dp.global_rank}.pt"))
    dp.barrier()
    dp.close()
    print(f"rank {args.rank}: done", flush=True)


if __name__ == "__main__":
    main()
