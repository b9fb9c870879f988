"""The control: a plain stand-in for the system that breaks one guarantee.

It writes the records a cluster would store, signing in the host's
integers with each key's algorithm, but collects the collective signature
from ``suff - 1`` servers, one short of what the configuration states: the
step a faster write path would be tempted to take.  The reference must
find every such record bad.
"""

from __future__ import annotations

from portbench.reference import check, sigs, wire

__all__ = ["records"]


def records(servers: list, writers: list, n_storage: int, items: list[tuple[bytes, bytes, int]],
            short_by: int = 1) -> dict[bytes, list[bytes]]:
    """Each storage node's record of each ``(variable, value, writer)`` item;
    ``servers`` and ``writers`` are private keys tagged by their algorithm
    (:mod:`portbench.reference.sigs`)."""
    _f, _min, _thr, suff = check.bmasking(len(servers))
    signers = servers[: suff - short_by]
    out = {}
    for var, value, w in items:
        writer = writers[w]
        wsig = sigs.sign(writer, wire.serialize_record(var, value, 1, upto="t"))
        sig = wire.SigPacket(1, 1, True, wire.serialize_entries([(sigs.signer_id(sigs.public_of(writer)), wsig)]),
                             None)
        body = wire.serialize_record(var, value, 1, sig, upto="sig")
        entries = [(sigs.signer_id(sigs.public_of(k)), sigs.sign(k, body)) for k in signers]
        ss = wire.SigPacket(1, 1, True, wire.serialize_entries(entries), None)
        out[var] = [wire.serialize_record(var, value, 1, sig, ss)] * n_storage
    return out
