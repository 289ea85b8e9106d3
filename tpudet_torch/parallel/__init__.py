"""Data and tensor parallelism over ``torch.distributed``
(``tpudet.parallel``): one process per card on a ("data", "model") mesh.
The global batch is split by rows over the data axis and the gradients are
averaged over it; the model axis cuts the wide layers Megatron-style
(``sharding_rules.tp_layout``, ``models.layers.shard_model``)."""

from tpudet_torch.parallel.mesh import (  # noqa: F401
    DataParallel,
    init_data_parallel,
    init_mesh,
)
