"""Share of the traced window in which nothing ran on the device: one
minus the union of the profiler's device intervals over the window, in
percent. None without a trace or without device events."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
