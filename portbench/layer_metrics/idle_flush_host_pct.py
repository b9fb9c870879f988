"""Percent of the window in which the card sat idle while a dispatcher's flush held items on the host (encoding, staging, waiting for the interpreter lock, decoding): the program's idle-state ledger
(``ops/idle.py``), registry counter ``device.idle.flush_host.seconds`` over the five
buckets' sum."""

BUCKETS = ("device.busy.seconds", "device.idle.gc.seconds", "device.idle.flush_host.seconds",
           "device.idle.queued.seconds", "device.idle.no_work.seconds")


def read(ctx):
    if not all(k in ctx.registry for k in BUCKETS):
        return None
    total = sum(ctx.registry[k] for k in BUCKETS)
    return 100.0 * ctx.registry["device.idle.flush_host.seconds"] / total if total > 0 else None
