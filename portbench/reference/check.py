"""The plain reference: holds what the cluster stored and answered to the
guarantees its configuration states.

It is given the public keys the benchmark made, the traffic the benchmark
issued (each write's value, when it was issued and whether the system
acknowledged it, in the order its one writer issued them), the values the
system's reads returned, and each storage node's latest record of every
variable written.  It works the quorum sizes out again from the number of
servers and storage nodes, parses the records with its own frozen copy of
the wire format (:mod:`portbench.reference.wire`) and verifies signatures
in the host's integers, by each signer's key algorithm
(:mod:`portbench.reference.sigs`: RSA with ``pow``, or plain P-256
ECDSA).  It returns counts, each of which a correct run holds at 0:

- ``missing_writes``: acknowledged writes that fewer storage nodes than
  the write quorum's threshold hold with their value (or a value the same
  writer issued later);
- ``bad_certificates``: of a sample of those writes, the ones where a
  storage node's record lacks the writer's valid signature or a collective
  signature of at least ``suff`` distinct servers of the clique;
- ``bad_reads``: reads that returned no value or one a regular register
  cannot return: older than the latest write acknowledged before the read
  began, or issued after the read ended.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from portbench.reference import sigs, wire

__all__ = ["Version", "Read", "Universe", "bmasking", "check", "write_threshold"]


def bmasking(n: int) -> tuple[int, int, int, int]:
    """``(f, min, threshold, suff)`` of a b-masking quorum clique of ``n``
    servers: f = (n-1)/3, min = 3f+1, threshold = 2f+1,
    suff = f + (n-f)/2 + 1."""
    f = (n - 1) // 3
    return f, 3 * f + 1, 2 * f + 1, f + (n - f) // 2 + 1


def write_threshold(n_storage: int) -> int:
    """Storage nodes that must acknowledge a write: the write quorum is the
    storage nodes outside the clique, a read-type clique of f + 1."""
    return (n_storage - 1) // 3 + 1


@dataclass
class Version:
    """One write of a variable, as the benchmark issued it."""

    value: bytes
    issued: float
    answered: float | None  # None: no answer came
    acked: bool


@dataclass
class Read:
    variable: bytes
    issued: float
    answered: float
    value: bytes | None


@dataclass
class Universe:
    """The public keys the benchmark made, servers' and clients', each
    tagged by its algorithm (:mod:`portbench.reference.sigs`)."""

    servers: list[tuple]
    clients: list[tuple]
    n_storage: int
    server_ids: dict[int, tuple] = field(init=False)

    def __post_init__(self):
        self.server_ids = {sigs.signer_id(k): k for k in self.servers}


def _certificate_ok(raw: bytes, rec: wire.Record, writer: tuple, uni: Universe, suff: int) -> bool:
    if rec.sig is None or rec.ss is None:
        return False
    try:
        wid = sigs.signer_id(writer)
        wsigs = [s for sid, s in wire.parse_entries(rec.sig.data) if sid == wid]
        if not wsigs or not sigs.verify(writer, wire.tbs(raw), wsigs[0]):
            return False
        body = wire.tbss(raw)
        valid: set[int] = set()
        for sid, s in wire.parse_entries(rec.ss.data):
            if len(valid) >= suff:
                break
            key = uni.server_ids.get(sid)
            if key is not None and sid not in valid and sigs.verify(key, body, s):
                valid.add(sid)
        return len(valid) >= suff
    except ValueError:
        return False


def check(uni: Universe, history: dict[bytes, tuple[int, list[Version]]], reads: list[Read],
          stored: dict[bytes, list[bytes | None]], sample: list[bytes]) -> dict[str, int]:
    """``history``: variable -> (writer's client index, its versions in
    issue order); ``stored``: variable -> each storage node's latest record
    (``None`` where it holds none), for every variable of ``history``;
    ``sample``: the variables whose certificates are verified."""
    _f, _min, _threshold, suff = bmasking(len(uni.servers))
    need = write_threshold(uni.n_storage)
    missing = 0
    holders: dict[bytes, list[tuple[bytes, wire.Record]]] = {}
    for var, (writer, versions) in history.items():
        acked = [i for i, v in enumerate(versions) if v.acked]
        if not acked:
            continue
        allowed = {v.value for v in versions[acked[-1]:]}
        held = []
        for raw in stored.get(var, ()):
            if raw is None:
                continue
            try:
                rec = wire.parse_record(raw)
            except ValueError:
                continue
            if rec.variable == var and rec.value in allowed:
                held.append((raw, rec))
        holders[var] = held
        if len(held) < need:
            missing += 1
    bad_cert = 0
    for var in sample:
        if var not in holders:
            continue
        writer = uni.clients[history[var][0]]
        seen: dict[bytes, bool] = {}
        ok = bool(holders[var])
        for raw, rec in holders[var]:
            if raw not in seen:
                seen[raw] = _certificate_ok(raw, rec, writer, uni, suff)
            ok = ok and seen[raw]
        if not ok:
            bad_cert += 1
    bad_reads = 0
    for r in reads:
        versions = history.get(r.variable, (0, []))[1]
        idx = next((i for i, v in enumerate(versions) if v.value == r.value), None)
        if idx is None or versions[idx].issued > r.answered:
            bad_reads += 1
            continue
        done_before = [i for i, v in enumerate(versions)
                       if v.acked and v.answered is not None and v.answered < r.issued]
        if done_before and idx < done_before[-1]:
            bad_reads += 1
    return {"missing_writes": missing, "bad_certificates": bad_cert, "bad_reads": bad_reads}
