"""Share of its roofline that the RoI Align forward kernel reaches: the
least time of each ``tpudet::roi_align_fwd`` call of the traced stretch
(``work/roi_align.py``, from the shapes the trace recorded), summed, over
the device time of the kernels launched under those calls."""

from detbench import trace
from detbench.work import roi_align


def read(ctx):
    if ctx.peaks is None:
        return None
    calls = trace.under(ctx.events, "tpudet::roi_align_fwd")
    spent = sum(us for _, us in calls) / 1e6
    if not calls or spent <= 0:
        return None
    bound = sum(roi_align.bound_s(op["shapes"], op["dtypes"], op["scalars"],
                                  ctx.peaks) for op, _ in calls)
    return 100.0 * bound / spent
