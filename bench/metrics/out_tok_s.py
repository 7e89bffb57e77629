"""Output tokens that landed on the host in the window, over its
seconds."""

from bench.accounting import tokens_in


def read(ctx):
    return tokens_in(ctx.recs, ctx.t_open, ctx.t_close) / ctx.seconds
