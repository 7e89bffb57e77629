"""Decode attention's share of its roofline in the traced window: the
least time the work could take on the card (the larger of its FLOPs over
the peak rate and its bytes over the peak bandwidth) over the device time
of the kernels of the ``decode_attn`` role. The work is the family's
count for the tokens decoded in the traced window: each reads the cached
rows its position attends (K and V once), its query in and its output
out. Idle slots' reads are no work. None without a trace, a peak table
entry, or decode-attention kernel time."""


def read(ctx):
    tr, pk = ctx.trace, ctx.peaks
    if tr is None or pk is None:
        return None
    t_dev = tr.time_of(ctx.kernel_roles.get("decode_attn", []))
    if t_dev <= 0:
        return None
    flops = nbytes = 0.0
    for r in ctx.recs:
        for j, t in enumerate(r.tokens):
            if j and tr.t0 <= t < tr.t1:
                rows = ctx.family.attended_rows(ctx.cfg, r.prompt_len + j - 1)
                f, b = ctx.family.decode_attn_work(ctx.cfg, rows)
                flops += f
                nbytes += b
    bound = max(flops / pk["bf16_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * bound / t_dev if bound else None
