"""Mean ms of a server's BATCH_WRITE handler, verification and storage
included (registry timer ``server.batch_write.handler``)."""


def read(ctx):
    return ctx.timer_ms("server.batch_write.handler")
