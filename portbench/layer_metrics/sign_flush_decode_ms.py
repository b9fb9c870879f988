"""Mean host ms of a sign flush after a launch's result is back until
the next upload or the answer: σ to integers, the CRT recombination, the
fault check's host side and the byte conversion (registry timer
``signdispatch.flush.decode``)."""


def read(ctx):
    return ctx.timer_ms("signdispatch.flush.decode")
