"""Tensor parallelism of the PyTorch port on the CPU, two-stage families:
two real processes in a gloo tp=2 group (``tests/_torch_tp_worker.py``,
each with a hard timeout) against one process and against tpudet's own
sharded step.

One ``make_train_step`` step of the tiny Faster R-CNN, FPN Faster R-CNN
and Cascade R-CNN (the RoI heads' ``fc1`` column- and ``fc2`` row-parallel)
on the global batch of ``tests/_torch_dp_worker.py``, from tpudet's
initial state (``create_train_state`` from ``key(0)``, converted) with the
sampler draws of tpudet's step:

* both ranks' metrics equal the one-process step's within 1e-6 relative,
  and each rank's gradient and updated parameter shards equal their
  blocks of the one-process step's tensors within 1e-6 of each tensor's
  largest magnitude (floored at 1e-6 of the model's largest), as
  ``test_torch_parallel.py`` holds data parallelism;
* both ranks' metrics, gradient, momentum and parameter shards equal
  their blocks of tpudet's step on a 1 x 2 ("data", "model") mesh of the
  forced host devices (``shard_train_state``, ``make_train_step(mesh=)``)
  within the port-vs-tpudet step tests' tolerances
  (``_torch_tp_check.assert_step_matches_tpudet``) plus 4x the port's own
  f32 GroupNorm rounding of each tensor: the one-process step with
  GroupNorm in float64 (``groupnorm_in_f64``) equals tpudet's within
  those tolerances alone, and its distance from the plain one-process
  step is that rounding (the tiny GN backbone's first layers only).
"""

import pytest
import torch

from tests import _torch_tp_worker as worker
from tests._torch_tp_check import (
    assert_shards_equal,
    assert_step_matches_tpudet,
    f32_rounding,
    groupnorm_in_f64,
    run_mesh,
    tpudet_steps,
)

torch.set_num_threads(2)
FAMILIES = ("faster_rcnn", "fpn", "cascade")


def run_families(tmp_path_factory, families, with_tpudet=None):
    """tpudet's 1 x 2 mesh step of each of ``with_tpudet`` (default: every
    family; DETR's at dropout 0 as ``detr_no_dropout``, beside the port's
    at 0.1), the port's tp=2 pair from the same start (the seed-0 state
    for the others), and the one-process steps -> (the ranks' records,
    {family: (start, tpudet's step)}, {family: the one-process step, and
    the same step with GroupNorm in float64 where tpudet's is taken})."""
    with_tpudet = families if with_tpudet is None else with_tpudet
    jax_families = ["detr_no_dropout" if f == "detr" else f
                    for f in with_tpudet]
    tpudet = {name: tpudet_steps(name, 1, 2) for name in jax_families}
    names = list(dict.fromkeys(list(families) + jax_families))
    ranks = run_mesh(tmp_path_factory.mktemp("tp"), 2, 2, ",".join(names),
                     start={k: v[0] for k, v in tpudet.items()})
    one = {}
    for name in names:
        cfg, init = worker.family_configs()[name], tpudet.get(name, [None])[0]
        one[name] = [worker.step_once(cfg, None, init=init)[1]]
        if name in tpudet:
            with groupnorm_in_f64():
                one[name].append(worker.step_once(cfg, None, init=init)[1])
    return ranks, tpudet, one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_families(tmp_path_factory, FAMILIES)


def check_family(runs, name):
    """Both ranks' step of ``name`` against the one-process step from the
    same start."""
    ranks, _, one = runs
    ref = one[name][0]
    for r in ranks:
        got = r[name]
        assert r["model_size"] == 2 and r["rank"] == 0
        assert set(got["metrics"]) == set(ref["metrics"])
        for k, v in ref["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-6), k
        for key in ("grads", "params"):
            assert_shards_equal(got[key], ref[key], got["layout"],
                                r["model_rank"], 2, f"{name} {key}")
    cut = [k for k, s in ranks[0][name]["layout"].items()
           if s.kind != "replicated"]
    assert cut and all(ranks[0][name]["params"][k].shape
                       != ref["params"][k].shape for k in cut)
    # The model peers hold the same replicated parameters.
    for k, s in ranks[0][name]["layout"].items():
        if s.kind == "replicated":
            assert torch.equal(ranks[0][name]["params"][k],
                               ranks[1][name]["params"][k]), k


def check_tpudet(runs, name):
    """The one-process step of ``name`` with GroupNorm in float64, and
    both ranks' step, against tpudet's sharded step."""
    ranks, tpudet, one = runs
    start, (want,) = tpudet[name]
    plain, wide = one[name]
    replicated = {k: type(s)("replicated")
                  for k, s in ranks[0][name]["layout"].items()}
    assert_step_matches_tpudet(wide, want, start["weights"], replicated, 0,
                               1, f"{name} one process, GroupNorm in f64")
    slack = f32_rounding(plain, wide)
    for r in ranks:
        got = r[name]
        assert_step_matches_tpudet(got, want, start["weights"], got["layout"],
                                   r["model_rank"], 2,
                                   f"{name} rank {r['model_rank']}", slack)


@pytest.mark.parametrize("name", FAMILIES)
def test_tp2_step_equals_one_process_step(runs, name):
    check_family(runs, name)


@pytest.mark.parametrize("name", FAMILIES)
def test_tp2_step_equals_tpudet_sharded_step(runs, name):
    check_tpudet(runs, name)
