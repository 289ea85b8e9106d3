"""Device milliseconds per step of ViTDet's global attention cores: the
kernels launched under the program's ``tpudet/attn_global`` spans
(``models/vit.py``: from q, k and v after their projections to the
output before ``out``, the relative-position terms included), per
``tpudet/step`` of the traced stretch. None where a step holds another
number of such spans than the configuration has global blocks (a program
without the spans reads nothing), or where no device time was recorded."""

from detbench import spans, trace
from detbench.work import vit_attn

SPANS = {"global": "tpudet/attn_global", "window": "tpudet/attn_window"}


def ms_per_step(ctx, kind: str):
    """Device ms per step under the spans of ``kind``, or None."""
    steps = spans.steps(ctx)
    if not steps:
        return None
    want = vit_attn.block_kinds(ctx.cell.config).count(kind)
    calls = trace.under(ctx.events, SPANS[kind])
    total = 0.0
    for s in steps:
        mine = [us for r, us in calls if r["tid"] == s["tid"]
                and r["start"] >= s["start"] and r["end"] <= s["end"]]
        if len(mine) != want:
            return None
        total += sum(mine)
    return total / len(steps) / 1e3 if total > 0 else None


def read(ctx):
    return ms_per_step(ctx, "global")
