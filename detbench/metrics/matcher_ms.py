"""Host milliseconds per step of the Hungarian matcher's solve: the
program's ``tpudet/matcher`` spans (``ops/hungarian.py``) less what their
``tpudet/matcher/fetch`` children cover (the copies of the cost to the
host, which wait for the card), per ``tpudet/step`` of the traced
stretch."""

from detbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, "tpudet/matcher",
                             less="tpudet/matcher/fetch")
