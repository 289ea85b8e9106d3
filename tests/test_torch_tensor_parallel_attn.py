"""Tensor parallelism of the PyTorch port on the CPU, attention families:
two real processes in a gloo tp=2 group against one process and against
tpudet's own sharded step, as ``test_torch_tensor_parallel.py`` holds the
two-stage families.

DETR (its attention cut at the heads, the FFN column then row, at its
preset's dropout of 0.1: the FFN's mask is drawn at full width and cut to
the rank's columns, and a mask drawn per shard would fail; against tpudet
at the tiny config's dropout of 0, since tpudet draws its masks from its
own generator), Deformable DETR (the value projection cut at the heads,
the replicated offsets and attention weights cut to the rank's heads, 2 of
4 heads per rank) and ViTDet (query/key/value, out and the MLP), the last
two from the seed-0 state here: their steps from tpudet's state against
tpudet's are ``test_torch_tensor_parallel_deformable.py``'s and
``test_torch_tensor_parallel_vit.py``'s (tpudet's steps of the three
families take ~70 s to build, too long for one file).
"""

import pytest
import torch

from tests.test_torch_tensor_parallel import (
    check_family,
    check_tpudet,
    run_families,
)

torch.set_num_threads(2)
FAMILIES = ("detr", "deformable_detr", "vitdet")
WITH_TPUDET = ("detr",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_families(tmp_path_factory, FAMILIES, WITH_TPUDET)


@pytest.mark.parametrize("name", FAMILIES)
def test_tp2_step_equals_one_process_step(runs, name):
    check_family(runs, name)


@pytest.mark.parametrize("name", WITH_TPUDET)
def test_tp2_step_equals_tpudet_sharded_step(runs, name):
    check_tpudet(runs, "detr_no_dropout" if name == "detr" else name)
