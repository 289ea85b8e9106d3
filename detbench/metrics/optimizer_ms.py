"""Host milliseconds per step of the update after the backward: the
program's ``tpudet/optimizer`` spans (``train/step.py``: the frozen
gradients dropped, the all-reduces, the norm and clipping, the learning
rate, ``optimizer.step()``, the EMA and the metrics' reduction), per
``tpudet/step`` of the traced stretch."""

from detbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, "tpudet/optimizer")
