"""Share of the engine's slots holding a request after each step of the
window, over all its steps, in percent."""


def read(ctx):
    if not ctx.steps:
        return None
    occ = sum(o for *_, o in ctx.steps)
    return 100.0 * occ / (len(ctx.steps) * ctx.slots)
