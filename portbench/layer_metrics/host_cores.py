"""Cores the process used over the window: its CPU seconds, user and
system (registry counter ``process.cpu_seconds``, ``os.times()`` at each
read), over the window's seconds."""


def read(ctx):
    cpu = ctx.registry.get("process.cpu_seconds")
    return cpu / ctx.window_s if cpu and ctx.window_s > 0 else None
