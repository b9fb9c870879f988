"""Mean host ms of a verify dispatcher flush: encoding, staging, the
launch and the verdicts (registry timer ``dispatch.flush.seconds``)."""


def read(ctx):
    return ctx.timer_ms("dispatch.flush.seconds")
