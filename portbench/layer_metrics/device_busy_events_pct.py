"""Percent of the window in which the card ran a launch: the union of the launches' device intervals, each from its first upload for its device seconds on the card's own clock: the program's idle-state ledger
(``ops/idle.py``), registry counter ``device.busy.seconds`` over the five
buckets' sum."""

BUCKETS = ("device.busy.seconds", "device.idle.gc.seconds", "device.idle.flush_host.seconds",
           "device.idle.queued.seconds", "device.idle.no_work.seconds")


def read(ctx):
    if not all(k in ctx.registry for k in BUCKETS):
        return None
    total = sum(ctx.registry[k] for k in BUCKETS)
    return 100.0 * ctx.registry["device.busy.seconds"] / total if total > 0 else None
