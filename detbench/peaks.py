"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates at the full 700 W): per second, bf16 tensor-core
FLOPs, f32 FLOPs outside the tensor cores and HBM bytes."""

from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    "H100": {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card or host not in the table."""
    for key, value in PEAKS.items():
        if key in kind:
            return value
    return None
