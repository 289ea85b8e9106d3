"""Tensor parallelism of the PyTorch port on the CPU, Deformable DETR:
the tiny Deformable DETR's tp=2 step (the value projection cut at the
heads, the replicated offsets and attention weights cut to the rank's 2 of
4 heads, the FFN column then row) from tpudet's initial state, against one
process and against tpudet's own step on a 1 x 2 mesh, as
``test_torch_tensor_parallel.py`` holds the two-stage families (a file of
its own: tpudet's Deformable DETR step takes ~40 s to build).
"""

import pytest
import torch

from tests.test_torch_tensor_parallel import (
    check_family,
    check_tpudet,
    run_families,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_families(tmp_path_factory, ("deformable_detr",))


def test_tp2_deformable_detr_step_equals_one_process_step(runs):
    check_family(runs, "deformable_detr")


def test_tp2_deformable_detr_step_equals_tpudet_sharded_step(runs):
    check_tpudet(runs, "deformable_detr")
