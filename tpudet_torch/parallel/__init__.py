"""Data parallelism over ``torch.distributed`` (``tpudet.parallel``): one
process per card, the global batch split by rows, the gradients averaged
over the group. The data axis only; tensor parallelism waits (ROADMAP.md,
Queue 1 item 32)."""

from tpudet_torch.parallel.mesh import DataParallel, init_data_parallel  # noqa: F401
