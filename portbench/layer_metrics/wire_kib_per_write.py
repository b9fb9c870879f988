"""KiB the clients sent and received per acknowledged write (registry
counters ``transport.bytes_out`` and ``transport.bytes_in``,
``side=client``, every command and transport)."""


def read(ctx):
    keys = [k for k in ctx.registry
            if k.split("{")[0] in ("transport.bytes_in", "transport.bytes_out")
            and "side=client" in k.partition("{")[2]]
    writes = sum(r is True for c in ctx.calls for op, r in zip(c.ops, c.results) if op.kind != "read")
    total = sum(ctx.registry[k] for k in keys)
    return total / 1024.0 / writes if total and writes else None
