"""Tensor parallelism of the PyTorch port on the CPU, ViTDet: the tiny
ViTDet's tp=2 step (the blocks' query/key/value and MLP ``fc1`` column-,
``out`` and ``fc2`` row-parallel) from tpudet's initial state with the
draws of tpudet's step, against one process and against tpudet's own step
on a 1 x 2 mesh, as ``test_torch_tensor_parallel.py`` holds the two-stage
families (a file of its own: tpudet's ViTDet step takes ~35 s to build).
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
    return run_families(tmp_path_factory, ("vitdet",))


def test_tp2_vitdet_step_equals_one_process_step(runs):
    check_family(runs, "vitdet")


def test_tp2_vitdet_step_equals_tpudet_sharded_step(runs):
    check_tpudet(runs, "vitdet")
