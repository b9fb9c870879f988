"""Generation-2 (full) collections of the interpreter's collector in the
window: the program's registry counter ``process.gc.gen2.collections``
(a ``gc.callbacks`` hook, ``ops/idle.py``)."""


def read(ctx):
    return ctx.registry.get("process.gc.gen2.collections")
