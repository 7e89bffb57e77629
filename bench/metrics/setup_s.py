"""Process start to window open: torch and CUDA start, the kernel
library's load (its build in a fresh checkout), the weights, the engine
and its graph capture, the warm-up, and the fill or the lead-in."""


def read(ctx):
    return ctx.setup_s
