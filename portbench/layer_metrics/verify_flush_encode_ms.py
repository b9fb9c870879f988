"""Mean host ms of a verify flush before its first upload: the PKCS#1
encodings, byte rows, key-row lookups and the fill of the pinned slot
(registry timer ``dispatch.flush.encode``)."""


def read(ctx):
    return ctx.timer_ms("dispatch.flush.encode")
