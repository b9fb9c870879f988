"""Mean ms of the protocol client's sign phase of a write_many: the
BATCH_SIGN fan-out until every item holds suff shares (registry timer
``client.write_many.phase_sign``)."""


def read(ctx):
    return ctx.timer_ms("client.write_many.phase_sign")
