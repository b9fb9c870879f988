"""RPCs the clients sent per acknowledged write (registry counters
``transport.rpcs{side=client,...}``, every command and transport)."""


def read(ctx):
    keys = [k for k in ctx.registry
            if k.split("{")[0] == "transport.rpcs" and "side=client" in k.partition("{")[2]]
    writes = sum(r is True for c in ctx.calls for op, r in zip(c.ops, c.results) if op.kind != "read")
    total = sum(ctx.registry[k] for k in keys)
    return total / writes if total and writes else None
