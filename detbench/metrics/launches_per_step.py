"""Kernel and graph launches per step (``cudaLaunchKernel``,
``cudaLaunchKernelExC``, ``cuLaunchKernel``, ``cuLaunchKernelEx``,
``cudaGraphLaunch``), started inside the program's ``tpudet/step`` spans
on any host thread (the backward's launches come from the autograd
engine's thread), over the traced stretch's steps."""

from detbench import spans


def read(ctx):
    return spans.calls_per_step(ctx, spans.LAUNCHES)
