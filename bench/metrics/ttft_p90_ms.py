"""90th percentile (nearest rank) over every request due in the window,
from its due time to its first token landing; a request that failed, was
refused, or had no token by the end of the drain counts as waiting until
then."""

from bench.accounting import percentile, ttfts


def read(ctx):
    v = percentile(ttfts(ctx.recs, ctx.t_open, ctx.t_close, ctx.t_end), 90)
    return None if v is None else v * 1e3
