"""RoI Align forward: the Hopper kernel (``csrc/roi_align.cu``) and its
plain PyTorch version.

Replaces ``tpudet/kernels/roi_align.py::_roi_align_kernel`` (reached
through ``roi_align_pallas``). The TPU kernel keeps one image's feature map
in VMEM and fetches corner rows with aligned block loads plus a select,
because the TPU has no cheap gather; on Hopper the 4-corner gather is the
natural form. One launch pools all ``B x R`` RoIs, each with its image
index; threads run over channels of the NHWC map so corner loads and output
stores are contiguous.

What bounds it on the H100: bytes, the pooled output written once (the
feature map is read from L2, where one image's map fits many times over).
The design writes each output value once, accumulates in f32 in registers,
and reads bf16 or f32 input as it is.
"""

from __future__ import annotations

import ctypes

import torch

from tpudet_torch.kernels import _build
# The plain version: the gather form in ``ops.roi_align``, batched.
from tpudet_torch.ops.roi_align import roi_align_batched as roi_align_plain

# Launches of the CUDA kernel, one per wrapper call on a CUDA tensor.
LAUNCHES = 0

SOURCE = "tpudet_torch/kernels/csrc/roi_align.cu"
REPLACES = "tpudet/kernels/roi_align.py:32"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["roi_align", "roi_align_cuda", "roi_align_plain"]


def _lib():
    lib = _build.load("roi_align")
    fn = lib.tpudet_roi_align_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def roi_align_cuda(features: torch.Tensor, boxes: torch.Tensor,
                   image_index: torch.Tensor, output_size: int,
                   sampling_ratio: int = 2) -> torch.Tensor:
    """The kernel: ``[B, H, W, C]`` features (f32 or bf16), ``[K, 4]`` f32
    boxes in feature coordinates, ``[K]`` int32 image indices ->
    ``[K, S, S, C]`` in the features' dtype."""
    global LAUNCHES
    dev = features.device
    if dev.type != "cuda" or boxes.device != dev or image_index.device != dev:
        raise ValueError("roi_align_cuda needs all inputs on one CUDA device")
    if features.dtype not in _DTYPES:
        raise TypeError(f"roi_align_cuda takes f32 or bf16 features, got {features.dtype}")
    if boxes.dtype != torch.float32 or image_index.dtype != torch.int32:
        raise TypeError("roi_align_cuda takes f32 boxes and int32 image indices")
    if features.dim() != 4 or boxes.shape != (image_index.shape[0], 4):
        raise ValueError(f"bad RoI Align shapes {tuple(features.shape)}, "
                         f"{tuple(boxes.shape)}, {tuple(image_index.shape)}")
    if not (features.is_contiguous() and boxes.is_contiguous()
            and image_index.is_contiguous()):
        raise ValueError("roi_align_cuda needs contiguous NHWC features, boxes "
                         "and indices")
    _, h, w, c = features.shape
    k = boxes.shape[0]
    s, r = output_size, sampling_ratio
    out = torch.empty((k, s, s, c), dtype=features.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(features.data_ptr(), boxes.data_ptr(),
                     image_index.data_ptr(), out.data_ptr(),
                     k, h, w, c, s, r, _DTYPES[features.dtype], stream)
    if err != 0:
        raise RuntimeError(f"RoI Align kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              image_index: torch.Tensor, output_size: int,
              sampling_ratio: int = 2) -> torch.Tensor:
    """Dispatch by device: CUDA -> the kernel, CPU -> the plain version."""
    if features.device.type == "cuda":
        return roi_align_cuda(features, boxes, image_index, output_size,
                              sampling_ratio)
    if features.device.type == "cpu":
        return roi_align_plain(features, boxes, image_index, output_size,
                               sampling_ratio)
    raise ValueError(f"no RoI Align for device {features.device}")
