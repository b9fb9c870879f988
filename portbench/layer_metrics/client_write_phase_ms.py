"""Mean ms of the protocol client's write phase of a write_many: the
BATCH_WRITE fan-out until the write quorum acknowledges (registry timer
``client.write_many.phase_write``)."""


def read(ctx):
    return ctx.timer_ms("client.write_many.phase_write")
