"""Device milliseconds per step of ViTDet's window attention cores: the
kernels launched under the program's ``tpudet/attn_window`` spans, per
``tpudet/step`` of the traced stretch; None where a step holds another
number of such spans than the configuration has window blocks
(``global_attn_ms.py`` reads both kinds)."""

from detbench.metrics.global_attn_ms import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "window")
