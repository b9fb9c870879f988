"""Milliseconds the interpreter's generation-2 (full) collections took in
the window, in all: the program's registry counter
``process.gc.gen2.seconds``; 0 in a window without one, so the metric is
read wherever the counter exists (the mean pass is this over
``gc_full_collections``)."""


def read(ctx):
    s = ctx.registry.get("process.gc.gen2.seconds")
    return None if s is None else 1e3 * s
