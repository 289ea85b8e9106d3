"""Device milliseconds per batch of the backbone: the kernels launched
under the ``detbench::backbone`` range, which the benchmark opens and
closes with forward hooks on ``model.core.backbone`` during the traced
stretch."""

from detbench import trace


def read(ctx):
    calls = trace.under(ctx.events, "detbench::backbone")
    if not calls or not sum(us for _, us in calls):
        return None
    return sum(us for _, us in calls) / len(calls) / 1e3
