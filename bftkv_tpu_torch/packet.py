"""Binary wire format for the versioned triple ``<x, v, t, sig, ss, auth>``
(counterpart of ``bftkv_tpu/packet.py``, byte for byte the same codec).

- chunks are length-prefixed with a big-endian uint64; a zero-length chunk
  parses back as ``None``;
- the timestamp ``t`` is a big-endian uint64; ``t == 2**64 - 1`` marks a
  write-once value;
- a signature packet is ``type(1) | version(4, BE) | completed(1) |
  chunk(data) | chunk(cert)``; type 0 parses back as ``None``;
- ``tbs(pkt)`` is the prefix up to and including ``t`` (what the writer
  signs); ``tbss(pkt)`` additionally covers ``sig`` (what quorum members
  collectively sign).

Trailing fields may be omitted: a packet may stop after ``x``, after
``v``, after ``t``, etc., and the parser returns ``None``/``0`` defaults
for the rest — the protocol layer relies on this for short packets such
as Time requests.

The per-packet codec also has a C form, ``native/packetcodec.c``, which
the port builds into ``bftkv_tpu_torch/_build/native/``
(:mod:`bftkv_tpu_torch.native`); the pure-Python functions stay as the
fallback and the oracle (``_py_*``).  ``BFTKV_NATIVE_CODEC=off`` keeps
the pure codec.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass

from bftkv_tpu_torch import flags
from bftkv_tpu_torch.errors import ERR_MALFORMED_REQUEST

SIGNATURE_TYPE_NIL = 0
SIGNATURE_TYPE_NATIVE = 1  # our compact cert/signature format
# One byte on the wire (the reference's 256 constant never fits its own
# byte-typed field; we assign a real byte value instead).
SIGNATURE_TYPE_PASSWORD_AUTH_PROOF = 2

WRITE_ONCE_T = 2**64 - 1


@dataclass
class SignaturePacket:
    """A writer or collective signature (reference: packet/packet.go:25-31)."""

    type: int = SIGNATURE_TYPE_NATIVE
    version: int = 0
    completed: bool = True
    data: bytes | None = None
    cert: bytes | None = None


def write_chunk(buf: io.BytesIO, chunk: bytes | None) -> None:
    chunk = chunk or b""
    buf.write(struct.pack(">Q", len(chunk)))
    buf.write(chunk)


def _read_u64(r: io.BytesIO) -> int:
    """Read a big-endian uint64; EOFError at a clean boundary, protocol
    error on a torn header."""
    hdr = r.read(8)
    if len(hdr) == 0:
        raise EOFError
    if len(hdr) < 8:
        raise ERR_MALFORMED_REQUEST
    return struct.unpack(">Q", hdr)[0]


def read_chunk(r: io.BytesIO) -> bytes | None:
    length = _read_u64(r)
    if length == 0:
        return None
    # Bound-check before read: a hostile 2^63-scale prefix must be a clean
    # protocol error, not an OverflowError out of BytesIO.
    if length > len(r.getbuffer()) - r.tell():
        raise ERR_MALFORMED_REQUEST
    return r.read(length)


def _write_signature(buf: io.BytesIO, sig: SignaturePacket | None) -> None:
    if sig is None:
        sig = SignaturePacket(type=SIGNATURE_TYPE_NIL, completed=False)
    if not 0 <= sig.type <= 0xFF:
        raise ValueError(f"signature type {sig.type} does not fit one byte")
    buf.write(struct.pack(">BI?", sig.type, sig.version, sig.completed))
    write_chunk(buf, sig.data)
    write_chunk(buf, sig.cert)


def _read_signature(r: io.BytesIO) -> SignaturePacket | None:
    hdr = r.read(6)
    if len(hdr) == 0:
        raise EOFError
    if len(hdr) < 6:
        raise ERR_MALFORMED_REQUEST
    typ, version, completed = struct.unpack(">BI?", hdr)
    data = read_chunk(r)
    cert = read_chunk(r)
    if typ == SIGNATURE_TYPE_NIL:
        return None
    return SignaturePacket(
        type=typ, version=version, completed=completed, data=data, cert=cert
    )


# -- offset-based readers (hot path) ---------------------------------------
# The stream readers above stay for callers that genuinely consume a
# stream (keyring files, multi-record buffers).  The per-packet parsers
# below run thousands of times per batch handler call; a BytesIO per
# chunk was the top Python cost in the handler profile, so they walk
# (bytes, offset) instead.  Semantics are pinned equal to the stream
# readers by tests/test_packet_fuzz.py.


def _chunk_at(b: bytes, off: int) -> tuple[bytes | None, int]:
    n = len(b)
    if off == n:
        raise EOFError
    if off + 8 > n:
        raise ERR_MALFORMED_REQUEST
    length = int.from_bytes(b[off : off + 8], "big")
    off += 8
    if length == 0:
        return None, off
    if length > n - off:
        raise ERR_MALFORMED_REQUEST
    return b[off : off + length], off + length


def _u64_at(b: bytes, off: int) -> tuple[int, int]:
    n = len(b)
    if off == n:
        raise EOFError
    if off + 8 > n:
        raise ERR_MALFORMED_REQUEST
    return int.from_bytes(b[off : off + 8], "big"), off + 8


def _signature_at(b: bytes, off: int) -> tuple[SignaturePacket | None, int]:
    n = len(b)
    if off == n:
        raise EOFError
    if off + 6 > n:
        raise ERR_MALFORMED_REQUEST
    typ, version, completed = struct.unpack_from(">BI?", b, off)
    data, off = _chunk_at(b, off + 6)
    cert, off = _chunk_at(b, off)
    if typ == SIGNATURE_TYPE_NIL:
        return None, off
    return (
        SignaturePacket(
            type=typ, version=version, completed=completed,
            data=data, cert=cert,
        ),
        off,
    )


def serialize(
    variable: bytes,
    value: bytes | None = None,
    t: int | None = None,
    sig: SignaturePacket | None = None,
    ss: SignaturePacket | None = None,
    auth: bytes | None = None,
    *,
    nfields: int | None = None,
) -> bytes:
    """Serialize ``<x, v, t, sig, ss, auth>`` (reference: packet/packet.go:35-60).

    ``nfields`` limits how many leading fields are emitted (default: all six),
    mirroring the reference's variadic ``Serialize(x)``, ``Serialize(x, v)``,
    ... call shapes.
    """
    if nfields is None:
        nfields = 6
    buf = io.BytesIO()
    if nfields >= 1:
        write_chunk(buf, variable)
    if nfields >= 2:
        write_chunk(buf, value)
    if nfields >= 3:
        buf.write(struct.pack(">Q", t or 0))
    if nfields >= 4:
        _write_signature(buf, sig)
    if nfields >= 5:
        _write_signature(buf, ss)
    if nfields >= 6:
        write_chunk(buf, auth)
    return buf.getvalue()


@dataclass
class Packet:
    """Parsed ``<x, v, t, sig, ss, auth>`` with defaults for omitted tails."""

    variable: bytes | None = None
    value: bytes | None = None
    t: int = 0
    sig: SignaturePacket | None = None
    ss: SignaturePacket | None = None
    auth: bytes | None = None

    def serialize(self, nfields: int | None = None) -> bytes:
        return serialize(
            self.variable or b"",
            self.value,
            self.t,
            self.sig,
            self.ss,
            self.auth,
            nfields=nfields,
        )


def parse(pkt: bytes) -> Packet:
    """Parse a packet, tolerating omitted *trailing* fields. EOF before the
    first field is a malformed request — the reference only forgives EOF
    after ``variable`` (reference: packet/packet.go:62-115)."""
    out = Packet()
    try:
        out.variable, off = _chunk_at(pkt, 0)
    except EOFError:
        raise ERR_MALFORMED_REQUEST from None
    try:
        out.value, off = _chunk_at(pkt, off)
        out.t, off = _u64_at(pkt, off)
        out.sig, off = _signature_at(pkt, off)
        out.ss, off = _signature_at(pkt, off)
        out.auth, off = _chunk_at(pkt, off)
    except EOFError:
        pass
    return out


def _tbs_offset(pkt: bytes) -> int:
    """Offset just past ``t`` (reference: packet/packet.go:142-154)."""
    try:
        off = 0
        for _ in range(2):  # variable, value
            _, off = _chunk_at(pkt, off)
        off += 8  # timestamp
        if off > len(pkt):
            raise EOFError
    except EOFError:
        raise ERR_MALFORMED_REQUEST from None
    return off


def tbs(pkt: bytes) -> bytes:
    """Bytes covered by the writer signature (reference: packet/packet.go:156-168)."""
    return pkt[: _tbs_offset(pkt)]


def tbss(pkt: bytes) -> bytes:
    """Bytes covered by the collective signature
    (reference: packet/packet.go:170-190)."""
    off = _tbs_offset(pkt)
    try:
        _sig, end = _signature_at(pkt, off)
    except EOFError:
        raise ERR_MALFORMED_REQUEST from None
    return pkt[:end]


def parse_signature(pkt: bytes) -> SignaturePacket | None:
    try:
        return _signature_at(pkt, 0)[0]
    except EOFError:
        raise ERR_MALFORMED_REQUEST from None


def serialize_signature(sig: SignaturePacket | None) -> bytes:
    buf = io.BytesIO()
    _write_signature(buf, sig)
    return buf.getvalue()


def serialize_auth_request(phase: int, variable: bytes, adata: bytes) -> bytes:
    """(reference: packet/packet.go:266-278)"""
    buf = io.BytesIO()
    buf.write(bytes([phase & 0xFF]))
    write_chunk(buf, variable)
    write_chunk(buf, adata)
    return buf.getvalue()


def parse_auth_request(pkt: bytes) -> tuple[int, bytes | None, bytes | None]:
    """(reference: packet/packet.go:250-264)"""
    r = io.BytesIO(pkt)
    b = r.read(1)
    if len(b) < 1:
        raise ERR_MALFORMED_REQUEST
    phase = b[0]
    try:
        variable = read_chunk(r)
        adata = read_chunk(r)
    except EOFError:
        raise ERR_MALFORMED_REQUEST from None
    return phase, variable, adata


def serialize_list(items: list[bytes]) -> bytes:
    """Count-prefixed list of chunks — the payload of the batch commands
    (no reference analog; the reference carries one request per round)."""
    buf = io.BytesIO()
    buf.write(struct.pack(">I", len(items)))
    for it in items:
        write_chunk(buf, it)
    return buf.getvalue()


def parse_list(data: bytes) -> list[bytes]:
    if len(data) < 4:
        raise ERR_MALFORMED_REQUEST
    count = int.from_bytes(data[:4], "big")
    # Each item needs at least an 8-byte length header after the count.
    if count > (len(data) - 4) // 8:
        raise ERR_MALFORMED_REQUEST
    out: list[bytes] = []
    off = 4
    for _ in range(count):
        try:
            c, off = _chunk_at(data, off)
        except EOFError:
            raise ERR_MALFORMED_REQUEST from None
        out.append(c or b"")
    return out


def serialize_results(results: list[tuple[str | None, bytes]]) -> bytes:
    """Per-item outcomes of a batch command: ``(error_message | None,
    payload)`` per item.  Error strings round-trip through the interned
    error registry exactly like the x-error header does."""
    items = []
    for err, payload in results:
        if err is None:
            items.append(b"\x00" + payload)
        else:
            items.append(b"\x01" + err.encode())
    return serialize_list(items)


def parse_results(data: bytes) -> list[tuple[str | None, bytes]]:
    out: list[tuple[str | None, bytes]] = []
    for it in parse_list(data):
        if not it:
            raise ERR_MALFORMED_REQUEST
        if it[0] == 0:
            out.append((None, it[1:]))
        else:
            out.append((it[1:].decode(errors="replace"), b""))
    return out


# -- anti-entropy codecs (the sync plane; no reference analog) --------------
# A digest is the non-empty buckets of a replica's keyspace digest tree:
# count-prefixed entries of ``bucket_id(1) | bucket_hash(32)``.  A pull
# request names bucket ids (one byte each); a pull response is a
# count-prefixed list of raw stored records (full packets).  All three
# ride the existing list codec so the C fast path applies.

DIGEST_HASH_LEN = 32


def serialize_digest(buckets: dict[int, bytes]) -> bytes:
    items = [
        bytes([b]) + h for b, h in sorted(buckets.items()) if h is not None
    ]
    return serialize_list(items)


def parse_digest(data: bytes) -> dict[int, bytes]:
    """Inverse of :func:`serialize_digest`.  Entries of the wrong shape
    are a protocol error — digests come from untrusted peers, and a
    torn entry must not silently alias an empty bucket."""
    out: dict[int, bytes] = {}
    items = parse_list(data)
    if len(items) > 256:
        raise ERR_MALFORMED_REQUEST
    for it in items:
        if len(it) != 1 + DIGEST_HASH_LEN:
            raise ERR_MALFORMED_REQUEST
        out[it[0]] = it[1:]
    return out


def serialize_bucket_ids(ids: list[int]) -> bytes:
    return serialize_list([bytes([b]) for b in ids])


def parse_bucket_ids(data: bytes) -> list[int]:
    out = []
    items = parse_list(data)
    if len(items) > 256:
        raise ERR_MALFORMED_REQUEST
    for it in items:
        if len(it) != 1:
            raise ERR_MALFORMED_REQUEST
        out.append(it[0])
    return out


# -- round-collapsed write ack (piggyback plane; no reference analog) ------
# A WRITE_SIGN responder answers with ONE of:
#   accept:  0x00 | serialized SignaturePacket share (empty for a
#            storage-plane node that holds no seat in the sign quorum —
#            its ack counts toward the write threshold only);
#   decline: 0x01 | u64 stored_t — the responder's current timestamp
#            for the variable.  The client's optimistic timestamp was
#            stale; it retries the SAME round at max(stored_t)+1, which
#            is what lets the separate TIME round disappear from the
#            steady-state write.  A decline is NOT an error reply: the
#            legacy error tunnel (x-error header) carries no payload,
#            and the hint is the whole point.

WS_ACCEPT = 0
WS_DECLINE_T = 1


def serialize_ws_ack(
    share: bytes | None = None, decline_t: int | None = None
) -> bytes:
    if decline_t is not None:
        return bytes([WS_DECLINE_T]) + struct.pack(">Q", decline_t)
    return bytes([WS_ACCEPT]) + (share or b"")


def parse_ws_ack(data: bytes) -> tuple[int, bytes, int]:
    """``(status, share_bytes, stored_t)``; the irrelevant half of the
    pair is ``b""`` / ``0``.  Anything malformed is a protocol error —
    acks come from untrusted peers."""
    if not data:
        raise ERR_MALFORMED_REQUEST
    if data[0] == WS_ACCEPT:
        return WS_ACCEPT, data[1:], 0
    if data[0] == WS_DECLINE_T:
        if len(data) != 9:
            raise ERR_MALFORMED_REQUEST
        return WS_DECLINE_T, b"", struct.unpack(">Q", data[1:])[0]
    raise ERR_MALFORMED_REQUEST


# -- trace-context envelope (observability plane; no reference analog) -----
# The transport fan-out prepends this to the PLAINTEXT payload before
# session encryption, so a request's trace context crosses nodes (and
# processes) without touching the HTTP surface or the session layer;
# Server.handler strips it right after decrypt.  Unambiguous against
# every legitimate payload: a packet starts with the 8-byte big-endian
# length of ``variable``, bound-checked against the buffer, so its
# first byte is 0x00 for any packet under 2^56 bytes — 0xff can never
# begin a valid packet — and an auth request starts with a phase byte
# that conforming clients keep tiny.

TRACE_MAGIC = b"\xffTRC"
_TRACE_HDR = len(TRACE_MAGIC) + 16


def wrap_trace(trace_id: int, span_id: int, payload: bytes) -> bytes:
    return (
        TRACE_MAGIC
        + trace_id.to_bytes(8, "big")
        + span_id.to_bytes(8, "big")
        + payload
    )


def unwrap_trace(data: bytes) -> tuple[tuple[int, int] | None, bytes]:
    """``(context, payload)``: context is ``(trace_id, span_id)`` when
    the envelope is present, else None with the data untouched."""
    if len(data) >= _TRACE_HDR and data[: len(TRACE_MAGIC)] == TRACE_MAGIC:
        return (
            (
                int.from_bytes(data[4:12], "big"),
                int.from_bytes(data[12:20], "big"),
            ),
            data[_TRACE_HDR:],
        )
    return None, data


def write_bigint(buf: io.BytesIO, n: int | None) -> None:
    """(reference: packet/packet.go:288-294)"""
    if n is None:
        write_chunk(buf, b"")
        return
    if n < 0:
        raise ValueError("write_bigint: negative")
    length = (n.bit_length() + 7) // 8
    write_chunk(buf, n.to_bytes(length, "big"))


def read_bigint(r: io.BytesIO) -> int:
    """(reference: packet/packet.go:280-286)"""
    try:
        c = read_chunk(r)
    except EOFError:
        raise ERR_MALFORMED_REQUEST from None
    return int.from_bytes(c or b"", "big")


# -- optional C codec -------------------------------------------------------
# The per-packet codec is the top Python cost in the batch handlers
# native/packetcodec.c implements the identical grammar; the pure-Python
# functions above stay as the fallback AND as the semantics oracle the
# tests compare against.  Disable with BFTKV_NATIVE_CODEC=off.

_py_parse = parse
_py_tbs = tbs
_py_tbss = tbss
_py_parse_signature = parse_signature
_py_parse_list = parse_list
_py_serialize = serialize
_py_serialize_signature = serialize_signature


def _load_native_codec():
    if flags.raw("BFTKV_NATIVE_CODEC", "auto") == "off":
        return None
    from bftkv_tpu_torch import native

    mod = native.load("_packetcodec")
    if mod is not None:
        mod.set_malformed(ERR_MALFORMED_REQUEST)
    return mod


_C = _load_native_codec()

if _C is not None:

    def _sig_from_tuple(t):
        if t is None:
            return None
        return SignaturePacket(
            type=t[0], version=t[1], completed=t[2], data=t[3], cert=t[4]
        )

    def _sig_to_tuple(s):
        if s is None:
            return None
        if not 0 <= s.type <= 0xFF:
            raise ValueError(
                f"signature type {s.type} does not fit one byte"
            )
        return (s.type, s.version, s.completed, s.data, s.cert)

    def parse(pkt: bytes) -> Packet:  # noqa: F811
        variable, value, t, sig, ss, auth = _C.parse(pkt)
        return Packet(
            variable=variable,
            value=value,
            t=t,
            sig=_sig_from_tuple(sig),
            ss=_sig_from_tuple(ss),
            auth=auth,
        )

    def tbs(pkt: bytes) -> bytes:  # noqa: F811
        return pkt[: _C.tbs_offset(pkt)]

    def tbss(pkt: bytes) -> bytes:  # noqa: F811
        return pkt[: _C.tbss_end(pkt)]

    def parse_signature(pkt: bytes) -> SignaturePacket | None:  # noqa: F811
        return _sig_from_tuple(_C.parse_signature(pkt))

    def parse_list(data: bytes) -> list[bytes]:  # noqa: F811
        return _C.parse_list(data)

    def serialize(  # noqa: F811
        variable: bytes,
        value: bytes | None = None,
        t: int | None = None,
        sig: SignaturePacket | None = None,
        ss: SignaturePacket | None = None,
        auth: bytes | None = None,
        *,
        nfields: int | None = None,
    ) -> bytes:
        return _C.serialize(
            variable,
            value,
            t or 0,
            _sig_to_tuple(sig) if nfields is None or nfields >= 4 else None,
            _sig_to_tuple(ss) if nfields is None or nfields >= 5 else None,
            auth,
            6 if nfields is None else nfields,
        )

    def serialize_signature(sig: SignaturePacket | None) -> bytes:  # noqa: F811
        return _C.serialize_signature(_sig_to_tuple(sig))
