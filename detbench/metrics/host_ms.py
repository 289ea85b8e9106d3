"""Host milliseconds per step call: the benchmark's clock around each call
of the program's step, from the call until it returns (the launches and
the host's own work, not the wait for the card), averaged over the
window's calls outside the traced stretch."""


def read(ctx):
    calls = ctx.untraced.get("host_ms") or []
    return sum(calls) / len(calls) if calls else None
