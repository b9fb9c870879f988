"""Items per flush of the verify dispatcher (registry counters
``dispatch.items`` over ``dispatch.flushes``)."""


def read(ctx):
    return ctx.ratio("dispatch.items", "dispatch.flushes")
