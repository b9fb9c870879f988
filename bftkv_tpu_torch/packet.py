"""The chunk codec of the wire format (a copy of the part of
``bftkv_tpu/packet.py`` that the sidecar frames use).

A chunk is a big-endian uint64 length followed by that many bytes; a
zero-length chunk parses back as ``None``.  The rest of the packet codec
(the versioned triple, signature packets) comes with the protocol layer.
"""

from __future__ import annotations

import io
import struct

from bftkv_tpu_torch.errors import ERR_MALFORMED_REQUEST

__all__ = ["read_chunk", "write_chunk"]


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
