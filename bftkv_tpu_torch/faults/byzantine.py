"""Byzantine behaviors as failpoint handler programs.

Counterpart of ``bftkv_tpu/faults/byzantine.py``.

The reference expresses misbehavior by subclassing the real server
(reference: protocol/malserver_test.go:23-194); ``tests/mal_utils.py``
kept that shape.  These are the same behaviors factored into plain
functions with the ``server.admission`` handler-override signature
``fn(server, cmd, req, peer, sender) -> bytes | None``, so one
implementation serves both worlds:

- the chaos nemesis installs them as failpoint rules
  (:func:`make_colluder`, :func:`make_stale_replayer`) — a replica
  turns Byzantine for a scheduled window and back, no subclass swap;
- ``mal_utils.MalServer`` stays a subclass shim whose overridden
  handlers delegate here, keeping the existing Byzantine test suite
  green on the shared mechanism.

None of these behaviors can create authority: honest replicas still
run the full admission path, which is exactly what the chaos checker
verifies.
"""

from __future__ import annotations

from bftkv_tpu_torch import packet as pkt

__all__ = [
    "sign_anything",
    "store_unverified",
    "batch_sign_anything",
    "batch_store_unverified",
    "write_sign_anything",
    "batch_time_skew",
    "stale_replay_read",
    "make_colluder",
    "make_stale_replayer",
]


def sign_anything(server, cmd, req, peer, sender):
    """Sign whatever arrives: no writer-sig verify, no quorum
    certificate, no equivocation check (reference: malSign,
    malserver_test.go:64-89)."""
    pkt.parse(req)
    tbss = pkt.tbss(req)
    share = server.crypt.collective.sign(server.crypt.signer, tbss)
    return pkt.serialize_signature(share)


def store_unverified(server, cmd, req, peer, sender):
    """Store without any verification; conflicting values are kept when
    the storage supports a mal side area (reference: malWrite,
    malserver_test.go:91-112)."""
    p = pkt.parse(req)
    mal_write = getattr(server.storage, "mal_write", None)
    if mal_write is not None:
        mal_write(p.variable or b"", p.t, req)
    else:
        server.storage.write(p.variable or b"", p.t, req)
    return None


def batch_sign_anything(server, cmd, req, peer, sender):
    """The batch pipeline facing the same adversary: every item of the
    batch signed unverified."""
    results = []
    for r in pkt.parse_list(req):
        pkt.parse(r)
        share = server.crypt.collective.sign(server.crypt.signer, pkt.tbss(r))
        results.append((None, pkt.serialize_signature(share)))
    return pkt.serialize_results(results)


def batch_store_unverified(server, cmd, req, peer, sender):
    results = []
    mal_write = getattr(server.storage, "mal_write", None)
    for r in pkt.parse_list(req):
        p = pkt.parse(r)
        if mal_write is not None:
            mal_write(p.variable or b"", p.t, r)
        else:
            server.storage.write(p.variable or b"", p.t, r)
        results.append((None, b""))
    return pkt.serialize_results(results)


def write_sign_anything(server, cmd, req, peer, sender):
    """The round-collapsed write facing the colluder: sign whatever
    arrives AND store it unverified, acking with a genuine share —
    the piggybacked analog of sign_anything + store_unverified.  The
    honest quorum's checks (strict timestamps, equivocation-free share
    issuance, collective verification against the owner quorum) are
    what keep this harmless, which is exactly what the chaos checker
    asserts."""
    p = pkt.parse(req)
    share = server.crypt.collective.sign(server.crypt.signer, pkt.tbss(req))
    mal_write = getattr(server.storage, "mal_write", None)
    if mal_write is not None:
        mal_write(p.variable or b"", p.t, req)
    else:
        server.storage.write(p.variable or b"", p.t, req)
    return pkt.serialize_ws_ack(share=pkt.serialize_signature(share))


def batch_time_skew(server, cmd, req, peer, sender):
    """Answer every batched TIME item with a wildly inflated
    timestamp — the Byzantine clock answer a reader's max() absorbs
    (timestamps only order versions; a jump is legal, a rollback is
    what the monotonicity invariant forbids).  Also the colluder's
    guaranteed-manifest surface: BATCH_TIME fans to the FULL quorum,
    while the staged WRITE_SIGN/SIGN waves may never ask a replica
    outside the minimal prefix at all."""
    items = pkt.parse_list(req)
    fake = (1 << 40).to_bytes(8, "big")
    return pkt.serialize_results([(None, fake)] * len(items))


def stale_replay_read(server, cmd, req, peer, sender):
    """Answer a read with the OLDEST completed version — a genuinely
    signed but stale record.  An honest reader's deterministic
    resolution must still return the newest committed value."""
    p = pkt.parse(req)
    variable = p.variable or b""
    for t in sorted(server.storage.versions(variable)):
        try:
            raw = server.storage.read(variable, t)
        except Exception:
            continue
        try:
            cp = pkt.parse(raw)
        except Exception:
            continue
        if cp.ss is not None and cp.ss.completed:
            return raw
    return None  # nothing committed: indistinguishable from empty


#: The colluder behavior set, keyed by command name — what
#: ``mal_utils.MalServer`` does, as one table.
COLLUDER_HANDLERS = {
    "sign": sign_anything,
    "write": store_unverified,
    "batch_sign": batch_sign_anything,
    "batch_write": batch_store_unverified,
    "write_sign": write_sign_anything,
    "batch_time": batch_time_skew,
}


def make_colluder(registry, node_name: str) -> list:
    """Program one replica as a full colluder via failpoint rules on
    ``server.admission``; returns the rules (remove to heal)."""
    return [
        registry.add(
            "server.admission",
            "handle",
            match={"node": node_name, "cmd": cmd},
            fn=fn,
            rule_id=f"colluder:{node_name}:{cmd}",
        )
        for cmd, fn in sorted(COLLUDER_HANDLERS.items())
    ]


def make_stale_replayer(registry, node_name: str) -> list:
    """Program one replica to answer every single-read with its oldest
    completed version."""
    return [
        registry.add(
            "server.admission",
            "handle",
            match={"node": node_name, "cmd": "read"},
            fn=stale_replay_read,
            rule_id=f"stale:{node_name}:read",
        )
    ]
