"""Mean card ms of a verify flush: the sum of its launches' copies and
kernels between two CUDA events on the card's clock (registry timer
``dispatch.flush.device``)."""


def read(ctx):
    return ctx.timer_ms("dispatch.flush.device")
