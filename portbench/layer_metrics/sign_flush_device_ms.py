"""Mean card ms of a sign flush: its K2 launch and its fault check's K1
launch, copies included, between two CUDA events each on the card's
clock (registry timer ``signdispatch.flush.device``)."""


def read(ctx):
    return ctx.timer_ms("signdispatch.flush.device")
