"""Serving (``tpudet.serving``): ahead-of-time export of the inference
program and the artifact's loader, with the Hopper kernels inside the
exported graphs on the card."""

from tpudet_torch.serving.export import (
    ServingModel,
    export_model,
    load_artifact,
    save_artifact,
)

__all__ = ["ServingModel", "export_model", "load_artifact", "save_artifact"]
