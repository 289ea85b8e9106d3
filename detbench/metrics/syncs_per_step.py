"""CUDA runtime calls per step that block the host until the card is done
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, synchronous ``cudaMemcpy``), started inside the
program's ``tpudet/step`` spans on any host thread, over the traced
stretch's steps."""

from detbench import spans


def read(ctx):
    return spans.calls_per_step(ctx, spans.SYNCS)
