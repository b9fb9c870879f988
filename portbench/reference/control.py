"""The control: a plain stand-in for the system that breaks one guarantee.

It writes the records a cluster would store, signing with the host's
``pow``, but collects the collective signature from ``suff - 1`` servers,
one short of what the configuration states: the step a faster write path
would be tempted to take.  The reference must find every such record bad.
"""

from __future__ import annotations

from portbench.reference import check, wire

__all__ = ["records"]


def records(servers: list, writers: list, n_storage: int, items: list[tuple[bytes, bytes, int]],
            short_by: int = 1) -> dict[bytes, list[bytes]]:
    """Each storage node's record of each ``(variable, value, writer)`` item;
    ``servers`` and ``writers`` are (n, e, d, p, q) keys."""
    _f, _min, _thr, suff = check.bmasking(len(servers))
    signers = servers[: suff - short_by]
    out = {}
    for var, value, w in items:
        n, e, d, p, q = writers[w]
        wsig = wire.rsa_sign(wire.serialize_record(var, value, 1, upto="t"), n, d, p, q)
        sig = wire.SigPacket(1, 1, True, wire.serialize_entries([(wire.key_id(n, e), wsig)]), None)
        body = wire.serialize_record(var, value, 1, sig, upto="sig")
        entries = [(wire.key_id(sn, se), wire.rsa_sign(body, sn, sd, sp, sq)) for sn, se, sd, sp, sq in signers]
        ss = wire.SigPacket(1, 1, True, wire.serialize_entries(entries), None)
        out[var] = [wire.serialize_record(var, value, 1, sig, ss)] * n_storage
    return out
