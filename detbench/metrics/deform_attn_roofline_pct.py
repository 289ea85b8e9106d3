"""Share of their roofline that the multi-scale deformable attention
kernels reach: the least time of each ``tpudet::ms_deform_attn_fwd`` and
``_bwd`` call of the traced stretch (``work/deform_attn.py``, from the
recorded shapes), summed, over the device time of the kernels launched
under those calls."""

from detbench import trace
from detbench.work import deform_attn


def read(ctx):
    if ctx.peaks is None:
        return None
    bound = spent = 0.0
    for name, rule in (("tpudet::ms_deform_attn_fwd", deform_attn.forward_s),
                       ("tpudet::ms_deform_attn_bwd",
                        deform_attn.backward_s)):
        for op, us in trace.under(ctx.events, name):
            bound += rule(op["shapes"], op["dtypes"], ctx.peaks)
            spent += us / 1e6
    return 100.0 * bound / spent if spent > 0 else None
