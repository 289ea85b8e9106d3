"""FPN RoI Align, each RoI pooled once at its own level: the Hopper kernel
(``csrc/roi_align_window.cu``) and its plain PyTorch version.

Replaces ``tpudet/kernels/roi_align_window.py::_kernel`` (reached through
``roi_align_window_pallas`` and ``roi_align_window_pallas_batched``). The
TPU kernel cuts a ``window x window`` tile around each RoI out of its level
with one DMA and contracts it on the matrix unit, because the TPU cannot
gather; the window only bounds where a RoI's samples may fall. On Hopper
the 4-corner gather is the natural form: one launch pools all ``B x N``
RoIs, each reading its own level map through a small by-value table of
(pointer, H, W, stride).

What bounds it on the H100, as measured: instructions and the corner rows
they request, not bytes. The first design (a block per RoI and output
row, a thread per channel doing the level lookup, ``box / stride`` and
every sample's geometry) ran 2.13 ms at coco_r101_fpn's b=32 832x832 shape
against a 0.15 ms bytes bound. It now shares the RoI Align forward's
design (``kernels/roi_align.py``): a block per RoI looks up the level,
divides the box by its stride and computes the sample axes once into
shared memory; each warp pools an output row with 16 bytes of channels per
lane, one channel per lane where 16-byte vectors do not fit the maps.
It then takes 0.39 ms at that shape on an H100 (2.7x the bound), most of
it the corner-cell rows the samples read through L1 and L2.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from tpudet_torch.kernels import _build
from tpudet_torch.kernels.roi_align import vectorized
# The plain version: per-level gather form, in ``ops.roi_align``.
from tpudet_torch.ops.roi_align import roi_align_levels as roi_align_window_plain

# Launches of the CUDA kernel, one per wrapper call on a CUDA tensor.
LAUNCHES = 0

SOURCE = "tpudet_torch/kernels/csrc/roi_align_window.cu"
REPLACES = "tpudet/kernels/roi_align_window.py:109"

MAX_LEVELS = 4  # kMaxLevels of the CUDA source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["roi_align_window", "roi_align_window_cuda", "roi_align_window_plain"]


def _lib():
    lib = _build.load("roi_align_window")
    fn = lib.tpudet_roi_align_window_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p),
                        ctypes.POINTER(ctypes.c_int),
                        ctypes.POINTER(ctypes.c_int),
                        ctypes.POINTER(ctypes.c_float), ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def roi_align_window_cuda(features: Sequence[torch.Tensor],
                          strides: Sequence[float], boxes: torch.Tensor,
                          levels: torch.Tensor, output_size: int,
                          sampling_ratio: int = 2) -> torch.Tensor:
    """The kernel: ``[B, H_l, W_l, C]`` NHWC maps (f32 or bf16, one dtype),
    their strides, ``[B, N, 4]`` f32 image-pixel boxes and ``[B, N]`` int32
    0-based levels -> ``[B, N, S, S, C]`` in the features' dtype."""
    global LAUNCHES
    dev = boxes.device
    if dev.type != "cuda" or levels.device != dev or any(
            f.device != dev for f in features):
        raise ValueError("roi_align_window_cuda needs all inputs on one CUDA "
                         "device")
    if not 1 <= len(features) <= MAX_LEVELS or len(strides) != len(features):
        raise ValueError(f"roi_align_window_cuda takes 1..{MAX_LEVELS} levels "
                         f"with one stride each, got {len(features)} maps and "
                         f"{len(strides)} strides")
    dtype = features[0].dtype
    if dtype not in _DTYPES or any(f.dtype != dtype for f in features):
        raise TypeError("roi_align_window_cuda takes f32 or bf16 maps of one "
                        f"dtype, got {[f.dtype for f in features]}")
    if boxes.dtype != torch.float32 or levels.dtype != torch.int32:
        raise TypeError("roi_align_window_cuda takes f32 boxes and int32 levels")
    b, n = levels.shape
    c = features[0].shape[-1]
    if boxes.shape != (b, n, 4) or any(
            f.dim() != 4 or f.shape[0] != b or f.shape[3] != c
            for f in features):
        raise ValueError(f"bad FPN RoI Align shapes "
                         f"{[tuple(f.shape) for f in features]}, "
                         f"{tuple(boxes.shape)}, {tuple(levels.shape)}")
    if not (all(f.is_contiguous() for f in features) and boxes.is_contiguous()
            and levels.is_contiguous()):
        raise ValueError("roi_align_window_cuda needs contiguous NHWC maps, "
                         "boxes and levels")
    s, r = output_size, sampling_ratio
    count = len(features)
    out = torch.empty((b, n, s, s, c), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(
            (ctypes.c_void_p * count)(*(f.data_ptr() for f in features)),
            (ctypes.c_int * count)(*(f.shape[1] for f in features)),
            (ctypes.c_int * count)(*(f.shape[2] for f in features)),
            (ctypes.c_float * count)(*(float(st) for st in strides)),
            count, boxes.data_ptr(), levels.data_ptr(), out.data_ptr(),
            b, n, c, s, r, _DTYPES[dtype], vectorized(out, *features), stream)
    if err != 0:
        raise RuntimeError(f"FPN RoI Align kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def roi_align_window(features: Sequence[torch.Tensor],
                     strides: Sequence[float], boxes: torch.Tensor,
                     levels: torch.Tensor, output_size: int,
                     sampling_ratio: int = 2) -> torch.Tensor:
    """Dispatch by device: CUDA -> the kernel, CPU -> the plain version."""
    if boxes.device.type == "cuda":
        return roi_align_window_cuda(features, strides, boxes, levels,
                                     output_size, sampling_ratio)
    if boxes.device.type == "cpu":
        return roi_align_window_plain(features, strides, boxes, levels,
                                      output_size, sampling_ratio)
    raise ValueError(f"no FPN RoI Align for device {boxes.device}")
