"""Tensor-core precision probe: the Hopper kernel
(``csrc/precision_probe.cu``), its plain PyTorch version, and the probe's
entry point.

    python -m tpudet_torch.kernels.precision_probe [--device cuda|cpu]

Replaces ``scripts/mxu_precision_probe.py::_kernel_single`` and
``::_kernel_split`` (through ``_run``), which ask what the TPU's matrix unit
rounds: its default one-pass product rounds both operands to bf16, so a 0/1
selector against bf16 data is exact but f32 data loses ~2^-9 relative,
which splitting the data into two bf16 parts (``hi + lo``) restores. The
kernel asks the same of the H100's bf16 tensor cores (``mma.sync``
m16n8k16, f32 accumulation). The answer tells a later Hopper kernel that
puts f32 data through the tensor cores whether it needs the split that
``tpudet/kernels/deform_attn_mxu.py::_split`` makes.

The stages repeat the script's: A, a 0/1 selector against bf16 values, one
pass (must be exact); B, f32 data against a 0/1 matrix, one pass (reported);
C, the same with the split (must keep the contract ``err <= 5e-5 + 1e-3
|want|`` against an f64 reference). One JSON line per stage with the
script's keys; the entry exits non-zero if stage A or C breaks the contract.

What bounds the kernel on the H100: bytes (the f32 inputs read once and
the output written once, ~0.92 MB at the probe's shape), and below them
latency: each 16 x 16 output tile's block splits K over its 4 warps, which
load their fragments straight from global memory, 8 steps at a time. A
call through the wrapper takes longer on the host than on the card, so
its host path is kept to the checks, one allocation and the launch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from tpudet_torch.kernels import _build

# Launches of the CUDA kernel, one per wrapper call on CUDA tensors.
LAUNCHES = 0

SOURCE = "tpudet_torch/kernels/csrc/precision_probe.cu"
REPLACES = "scripts/mxu_precision_probe.py:34"

# The probe's product: [SP, K] . [K, N] (the script's shape).
SP, K, N = 256, 512, 128
TILE = 16  # every side must be a multiple of the tensor cores' 16
_DTYPES = (torch.float32, torch.bfloat16)

__all__ = ["precision_probe", "precision_probe_cuda", "precision_probe_plain",
           "probe_inputs", "run_probe", "main"]


def precision_probe_plain(x: torch.Tensor, m: torch.Tensor,
                          split: bool) -> torch.Tensor:
    """The plain version: the kernel's rounding with f32 products. One
    pass: ``bf16(x) . bf16(m)``; split: ``bf16(x) . bf16(m) + bf16(x -
    f32(bf16(x))) . bf16(m)``, each product in f32."""
    mb = m.to(torch.bfloat16).float()
    hi = x.to(torch.bfloat16)
    out = hi.float() @ mb
    if split:
        lo = (x.float() - hi.float()).to(torch.bfloat16)
        out = out + lo.float() @ mb
    return out


_FN = None  # the library's entry, bound on first use


def _lib():
    global _FN
    if _FN is None:
        fn = _build.load("precision_probe").tpudet_precision_probe
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def precision_probe_cuda(x: torch.Tensor, m: torch.Tensor,
                         split: bool) -> torch.Tensor:
    """The kernel: ``x [M, K]`` and ``m [K, N]`` (f32, or bf16 widened
    exactly), contiguous on one CUDA device, every side a multiple of 16 ->
    ``[M, N]`` f32."""
    global LAUNCHES
    dev = x.device
    if dev.type != "cuda" or m.device != dev:
        raise ValueError("precision_probe_cuda needs both operands on one "
                         "CUDA device")
    if x.dtype not in _DTYPES or m.dtype not in _DTYPES:
        raise TypeError(f"precision_probe_cuda takes f32 or bf16 operands, got "
                        f"{x.dtype}, {m.dtype}")
    if (x.dim() != 2 or m.dim() != 2 or x.shape[1] != m.shape[0]
            or x.shape[0] % TILE or x.shape[1] % TILE or m.shape[1] % TILE):
        raise ValueError(f"precision_probe_cuda takes [M, K] . [K, N] with "
                         f"sides multiple of {TILE}, got {tuple(x.shape)}, "
                         f"{tuple(m.shape)}")
    # Each call below costs a dispatch even when it returns its input.
    if x.dtype != torch.float32 or not x.is_contiguous():
        x = x.float().contiguous()
    if m.dtype != torch.float32 or not m.is_contiguous():
        m = m.float().contiguous()
    rows, depth = x.shape
    cols = m.shape[1]
    out = x.new_empty((rows, cols))
    # The launch takes microseconds, so the host path is kept short: the C
    # entry sets the card itself, and the current stream is read as a raw
    # handle (``torch.cuda.device`` and a ``torch.cuda.Stream`` object each
    # cost more host time than the kernel's whole run).
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = _lib()(x.data_ptr(), m.data_ptr(), out.data_ptr(), rows, cols,
                 depth, int(split), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"precision probe kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return out


def precision_probe(x: torch.Tensor, m: torch.Tensor,
                    split: bool) -> torch.Tensor:
    """Dispatch by device: CUDA -> the kernel, CPU -> the plain version."""
    if x.device.type == "cuda":
        return precision_probe_cuda(x, m, split)
    if x.device.type == "cpu":
        return precision_probe_plain(x, m, split)
    raise ValueError(f"no precision probe for device {x.device}")


def probe_inputs() -> Dict[str, Tuple[torch.Tensor, torch.Tensor, bool,
                                      np.ndarray]]:
    """The script's stages, drawn in its order from ``RandomState(0)``:
    ``{stage: (x, m, split, want)}`` with the f64 reference ``want``."""
    rng = np.random.RandomState(0)
    y0 = rng.randint(0, K, SP)
    s01 = torch.from_numpy(
        (np.arange(K)[None, :] == y0[:, None]).astype(np.float32))
    v = torch.from_numpy(rng.randn(K, N)).to(torch.float32).to(torch.bfloat16)
    want_a = v.float().numpy()[y0].astype(np.float64)
    x = rng.randn(SP, K).astype(np.float32)
    m01 = (rng.rand(K, N) < (4.0 / K)).astype(np.float32)
    want_bc = x.astype(np.float64) @ m01.astype(np.float64)
    xt, mt = torch.from_numpy(x), torch.from_numpy(m01)
    return {
        "A_select_bf16_single_pass": (s01.to(torch.bfloat16), v, False,
                                      want_a),
        "B_f32_data_single_pass_DEFAULT": (xt, mt, False, want_bc),
        "C_f32_data_bf16x2_split": (xt, mt, True, want_bc),
    }


# Stages held to the contract (the script's ``fail=True``).
CONTRACT_STAGES = ("A_select_bf16_single_pass", "C_f32_data_bf16x2_split")


def report(stage: str, got, want: np.ndarray) -> Dict[str, float]:
    """The script's line: max abs and rel error against the f64 reference
    and the share of elements outside ``5e-5 + 1e-3 |want|``."""
    got = np.asarray(got, np.float64)
    abs_err = np.abs(got - want)
    viol = abs_err > (5e-5 + 1e-3 * np.abs(want))
    return {"stage": stage, "max_abs": float(abs_err.max()),
            "max_rel": float((abs_err / np.maximum(np.abs(want), 1e-12)).max()),
            "mismatch_frac_contract": float(viol.mean())}


def run_probe(device="cuda") -> Tuple[List[Dict[str, float]], bool,
                                      Dict[str, torch.Tensor]]:
    """The three stages through :func:`precision_probe` on ``device`` ->
    (report lines, whether stage A or C broke the contract, outputs)."""
    lines, failed, outs = [], False, {}
    for stage, (x, m, split, want) in probe_inputs().items():
        out = precision_probe(x.to(device), m.to(device), split)
        outs[stage] = out.cpu()
        line = report(stage, outs[stage].numpy(), want)
        lines.append(line)
        if stage in CONTRACT_STAGES and line["mismatch_frac_contract"] > 0:
            failed = True
    return lines, failed, outs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernel) or cpu (the plain version)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card: pass --device cpu for the plain version",
                  file=sys.stderr)
            return 2
        name = torch.cuda.get_device_name(device)
    else:
        name = "cpu (plain version: f32 products)"
    print(f"backend: {name}", flush=True)
    lines, failed, _ = run_probe(device)
    for line in lines:
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
