"""The whole step's share of the card's bf16 peak over the window: the
model FLOPs of every token processed in it (each decoded token through
the layers, its attention over the rows it reads, and the head; each
prompt whose first token landed in the window, causal and windowed, the
head once) over the window's seconds times the peak. None without a peak
table entry."""


def read(ctx):
    if ctx.peaks is None:
        return None
    fam, c, flops = ctx.family, ctx.cfg, 0.0
    for r in ctx.recs:
        for j, t in enumerate(r.tokens):
            if not ctx.t_open <= t < ctx.t_close:
                continue
            if j == 0:
                flops += fam.prefill_flops(c, r.prompt_len)
            else:
                rows = fam.attended_rows(c, r.prompt_len + j - 1)
                flops += fam.token_flops(c, rows, head=True)
    return 100.0 * flops / (ctx.seconds * ctx.peaks["bf16_flops_per_s"])
