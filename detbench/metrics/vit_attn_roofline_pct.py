"""Share of their roofline that ViTDet's attention cores reach: the least
time of one batch's cores (``work/vit_attn.py``, from the configuration's
sizes and the canvas, whatever implements them) over the device time per
step under the ``tpudet/attn_global`` and ``tpudet/attn_window`` spans;
None where either kind reads nothing."""

from detbench.metrics.global_attn_ms import ms_per_step
from detbench.work import vit_attn


def read(ctx):
    if ctx.peaks is None:
        return None
    spent = [ms_per_step(ctx, kind) for kind in ("global", "window")]
    if None in spent:
        return None
    tr = ctx.cell.traffic
    h, w = tr["canvas"]
    bound = vit_attn.bound_s(ctx.cell.config, tr["batch"], h, w, ctx.peaks)
    return 100.0 * bound * 1e3 / sum(spent)
