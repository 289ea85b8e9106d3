"""The whole step's share of the card's bf16 peak: the model FLOPs of the
cell's shapes (the configuration's ``work`` counter: convolutions and
matrix products, backward at twice the forward in training) times the
steps completed in the window outside the traced stretch, over that
stretch of the window's time."""


def read(ctx):
    u = ctx.untraced
    if ctx.peaks is None or not u.get("steps") or u.get("seconds", 0) <= 0:
        return None
    return (100.0 * ctx.flops_per_step * u["steps"] / u["seconds"]
            / ctx.peaks["bf16_flops"])
