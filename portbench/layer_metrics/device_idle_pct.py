"""Percent of the window in which the card ran no kernel, copy or memset:
the window less the union of the device intervals of the profiler trace."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.window_s)
