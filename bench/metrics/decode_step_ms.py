"""Mean host time of the window's ``Engine.step()`` calls that admitted
nothing: the captured step's replay and the previous step's readback."""


def read(ctx):
    d = [t1 - t0 for t0, t1, adm, _ in ctx.steps if not adm]
    return sum(d) / len(d) * 1e3 if d else None
