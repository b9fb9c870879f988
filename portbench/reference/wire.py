"""A frozen, plain copy of the wire formats the reference reads.

- a record ``<x, v, t, sig, ss, auth>``: each chunk a big-endian uint64
  length and its bytes (length 0 reads as absent), ``t`` a big-endian
  uint64, a signature packet ``type(1) | version(4) | completed(1) |
  chunk(data) | chunk(cert)`` (type 0 reads as absent);
- what the writer signs is the record up to and including ``t``; what
  the quorum signs additionally covers the writer's signature packet;
- a signature packet's data is a run of entries ``signer id (uint64) |
  chunk(signature)``;
- a signer's id is the first 8 bytes (big-endian) of
  SHA-256(n as big-endian bytes || e as a big-endian uint32);
- a signature is RSA PKCS#1 v1.5 over SHA-256.

Malformed input raises ``ValueError``.
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass

__all__ = [
    "Record", "SigPacket", "key_id", "parse_entries", "parse_record", "rsa_sign", "rsa_verify",
    "serialize_entries", "serialize_record", "tbs", "tbss",
]

_SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


@dataclass
class SigPacket:
    type: int
    version: int
    completed: bool
    data: bytes | None
    cert: bytes | None


@dataclass
class Record:
    variable: bytes | None
    value: bytes | None
    t: int
    sig: SigPacket | None
    ss: SigPacket | None


def _chunk(b: bytes, off: int) -> tuple[bytes | None, int]:
    if off + 8 > len(b):
        raise ValueError("torn chunk header")
    n = int.from_bytes(b[off : off + 8], "big")
    off += 8
    if n > len(b) - off:
        raise ValueError("chunk runs past the end")
    return (b[off : off + n] if n else None), off + n


def _sig(b: bytes, off: int) -> tuple[SigPacket | None, int]:
    if off + 6 > len(b):
        raise ValueError("torn signature header")
    typ, version, completed = struct.unpack_from(">BI?", b, off)
    data, off = _chunk(b, off + 6)
    cert, off = _chunk(b, off)
    return (SigPacket(typ, version, completed, data, cert) if typ else None), off


def _t_end(b: bytes) -> int:
    off = 0
    for _ in range(2):
        _, off = _chunk(b, off)
    if off + 8 > len(b):
        raise ValueError("no timestamp")
    return off + 8


def parse_record(b: bytes) -> Record:
    """A stored record: every field through ``auth`` and nothing after."""
    variable, off = _chunk(b, 0)
    value, off = _chunk(b, off)
    off = _t_end(b)
    t = int.from_bytes(b[off - 8 : off], "big")
    sig, off = _sig(b, off)
    ss, off = _sig(b, off)
    _auth, off = _chunk(b, off)
    if off != len(b):
        raise ValueError("bytes after the record")
    return Record(variable, value, t, sig, ss)


def tbs(b: bytes) -> bytes:
    return b[: _t_end(b)]


def tbss(b: bytes) -> bytes:
    _, end = _sig(b, _t_end(b))
    return b[:end]


def parse_entries(data: bytes | None) -> list[tuple[int, bytes]]:
    out = []
    off = 0
    data = data or b""
    while off < len(data):
        if off + 16 > len(data):
            raise ValueError("torn entry")
        sid = int.from_bytes(data[off : off + 8], "big")
        sig, off = _chunk(data, off + 8)
        out.append((sid, sig or b""))
    return out


def key_id(n: int, e: int) -> int:
    h = hashlib.sha256(n.to_bytes((n.bit_length() + 7) // 8, "big") + struct.pack(">I", e))
    return int.from_bytes(h.digest()[:8], "big")


def _encoded(message: bytes, size: int) -> int:
    t = _SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
    return int.from_bytes(b"\x00\x01" + b"\xff" * (size - len(t) - 3) + b"\x00" + t, "big")


def rsa_verify(message: bytes, sig: bytes, n: int, e: int) -> bool:
    size = (n.bit_length() + 7) // 8
    s = int.from_bytes(sig, "big")
    return len(sig) == size and s < n and pow(s, e, n) == _encoded(message, size)


def rsa_sign(message: bytes, n: int, d: int, p: int, q: int) -> bytes:
    """``m^d mod n`` by the CRT, the encoding as in :func:`rsa_verify`."""
    size = (n.bit_length() + 7) // 8
    m = _encoded(message, size)
    m1 = pow(m, d % (p - 1), p)
    m2 = pow(m, d % (q - 1), q)
    s = m2 + (pow(q, -1, p) * (m1 - m2) % p) * q
    return s.to_bytes(size, "big")


# -- writing, for the control ----------------------------------------------


def _put_chunk(out: list, chunk: bytes | None) -> None:
    chunk = chunk or b""
    out.append(len(chunk).to_bytes(8, "big"))
    out.append(chunk)


def _put_sig(out: list, pkt: SigPacket | None) -> None:
    if pkt is None:
        out.append(struct.pack(">BI?", 0, 0, False))
        _put_chunk(out, None)
        _put_chunk(out, None)
        return
    out.append(struct.pack(">BI?", pkt.type, pkt.version, pkt.completed))
    _put_chunk(out, pkt.data)
    _put_chunk(out, pkt.cert)


def serialize_entries(entries: list[tuple[int, bytes]]) -> bytes:
    out: list = []
    for sid, sig in entries:
        out.append(sid.to_bytes(8, "big"))
        _put_chunk(out, sig)
    return b"".join(out)


def serialize_record(variable: bytes, value: bytes, t: int, sig: SigPacket | None = None,
                     ss: SigPacket | None = None, *, upto: str = "ss") -> bytes:
    """The record's bytes up to ``upto`` ("t", "sig" or "ss")."""
    out: list = []
    _put_chunk(out, variable)
    _put_chunk(out, value)
    out.append(t.to_bytes(8, "big"))
    if upto in ("sig", "ss"):
        _put_sig(out, sig)
    if upto == "ss":
        _put_sig(out, ss)
        _put_chunk(out, None)  # auth
    return b"".join(out)
