"""Host time of the window's ``Engine.step()`` calls that admitted, over
the requests they admitted (an admitting step waits for each first
token)."""


def read(ctx):
    adm = [(t1 - t0, a) for t0, t1, a, _ in ctx.steps if a]
    n = sum(a for _, a in adm)
    return sum(d for d, _ in adm) / n * 1e3 if n else None
