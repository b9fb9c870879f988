"""Mean host ms of a sign flush before its first upload: the PKCS#1
encodings, CRT exponents, byte rows and nibbles, key rows and the fill
of the pinned slot (registry timer ``signdispatch.flush.encode``)."""


def read(ctx):
    return ctx.timer_ms("signdispatch.flush.encode")
