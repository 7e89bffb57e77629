"""99th percentile (nearest rank) over every gap between two consecutive
output tokens of a request whose later token landed in the window, over
all requests, timed as each step's readback lands. In the open cells
about one gap in twenty to a hundred holds a prefill, so the 95th
percentile sits on the edge between decode gaps and those stalls and
jumps between them (8.5-16.6% spread in yi34b-chat-open); the 99th sits
inside the stalls (0.16-0.52%)."""

from bench.accounting import itls, percentile


def read(ctx):
    v = percentile(itls(ctx.recs, ctx.t_open, ctx.t_close), 99)
    return None if v is None else v * 1e3
