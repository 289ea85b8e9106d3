"""Multi-scale deformable attention: the Hopper kernel
(``csrc/deform_attn.cu``) and its plain PyTorch version.

Replaces ``tpudet/kernels/deform_attn_mxu.py::_fwd_banded_kernel`` and
``::_fwd_flat_kernel`` (reached through ``ms_deform_attn_mxu``), the forward
of TPU kernel 4. The TPU kernels contract one-hot selectors with each
level's value map on the matrix unit because the TPU cannot gather; their
banded/flat split, bf16 hi/lo operands and the rule that the head dim
divide 128 are TPU workarounds. On Hopper the bilinear 4-corner gather is
the natural form: one launch samples all levels for every query of the
batch, through a by-value table of (H_l, W_l, start offset); threads run
over the ``H * D`` output channels and each sample's corners and weights
are computed once per block in shared memory.

What bounds it on the H100: bytes (values, locations and weights read
once, the f32 output written once). The design writes each output value
once, accumulates in f32 in registers and reads bf16 or f32 values as they
are. The backward kernels wait for Deformable DETR training.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from tpudet_torch.kernels import _build
# The plain version: the gather-then-weighted-sum form, in ``ops.deform_attn``.
from tpudet_torch.ops.deform_attn import (
    level_start_offsets,
    ms_deform_attn_batched as ms_deform_attn_plain,
)

# Launches of the CUDA kernel, one per wrapper call on a CUDA tensor.
LAUNCHES = 0

SOURCE = "tpudet_torch/kernels/csrc/deform_attn.cu"
REPLACES = "tpudet/kernels/deform_attn_mxu.py:173"

MAX_LEVELS = 4  # kMaxLevels of the CUDA source
# Static shared memory a block may take without an opt-in: 32 bytes (four
# corner rows and four weights) per sample of one query.
MAX_SAMPLES = 48 * 1024 // 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["ms_deform_attn", "ms_deform_attn_cuda", "ms_deform_attn_plain"]


def _lib():
    lib = _build.load("deform_attn")
    fn = lib.tpudet_ms_deform_attn_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_int)] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ms_deform_attn_cuda(values: torch.Tensor,
                        level_shapes: Sequence[Tuple[int, int]],
                        locations: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """The kernel: ``values [B, N, H, D]`` (f32 or bf16), ``locations
    [B, Q, H, L, P, 2]`` f32, ``weights [B, Q, H, L, P]`` f32, all
    contiguous on one CUDA device -> ``[B, Q, H, D]`` f32."""
    global LAUNCHES
    dev = values.device
    if dev.type != "cuda" or locations.device != dev or weights.device != dev:
        raise ValueError("ms_deform_attn_cuda needs all inputs on one CUDA "
                         "device")
    if values.dtype not in _DTYPES:
        raise TypeError(f"ms_deform_attn_cuda takes f32 or bf16 values, got "
                        f"{values.dtype}")
    if locations.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("ms_deform_attn_cuda takes f32 locations and weights")
    b, n, h, d = values.shape
    q, lv, p = locations.shape[1], locations.shape[3], locations.shape[4]
    if not 1 <= lv <= MAX_LEVELS or len(level_shapes) != lv:
        raise ValueError(f"ms_deform_attn_cuda takes 1..{MAX_LEVELS} levels, "
                         f"got {len(level_shapes)} shapes for {lv} levels")
    offsets, total = level_start_offsets(level_shapes)
    if total != n:
        raise ValueError(f"level_shapes {tuple(level_shapes)} sum to {total} "
                         f"tokens, values carry {n}")
    if (locations.shape != (b, q, h, lv, p, 2)
            or weights.shape != (b, q, h, lv, p)):
        raise ValueError(f"bad deformable attention shapes {tuple(values.shape)}"
                         f", {tuple(locations.shape)}, {tuple(weights.shape)}")
    if h * lv * p > MAX_SAMPLES:
        raise ValueError(f"ms_deform_attn_cuda takes at most {MAX_SAMPLES} "
                         f"samples per query, got H*L*P = {h * lv * p}")
    if not (values.is_contiguous() and locations.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("ms_deform_attn_cuda needs contiguous values, "
                         "locations and weights")
    out = torch.empty((b, q, h, d), dtype=torch.float32, device=dev)
    ints = ctypes.c_int * lv
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(
            values.data_ptr(), locations.data_ptr(), weights.data_ptr(),
            out.data_ptr(), b, n, q, h, d, lv, p,
            ints(*(hl for hl, _ in level_shapes)),
            ints(*(wl for _, wl in level_shapes)), ints(*offsets),
            _DTYPES[values.dtype], stream)
    if err != 0:
        raise RuntimeError(f"deformable attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out


def ms_deform_attn(values: torch.Tensor,
                   level_shapes: Sequence[Tuple[int, int]],
                   locations: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Dispatch by device: CUDA -> the kernel, CPU -> the plain version."""
    if values.device.type == "cuda":
        return ms_deform_attn_cuda(values, level_shapes, locations, weights)
    if values.device.type == "cpu":
        return ms_deform_attn_plain(values, level_shapes, locations, weights)
    raise ValueError(f"no deformable attention for device {values.device}")
