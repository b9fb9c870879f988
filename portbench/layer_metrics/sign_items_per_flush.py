"""Items per flush of the sign dispatcher (registry counters
``signdispatch.items`` over ``signdispatch.flushes``)."""


def read(ctx):
    return ctx.ratio("signdispatch.items", "signdispatch.flushes")
