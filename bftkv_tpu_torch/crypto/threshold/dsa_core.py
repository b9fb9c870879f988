"""Dealerless threshold DSA core, shared by DSA and ECDSA group plugins
(counterpart of ``bftkv_tpu/crypto/threshold/dsa_core.py``).

Capability parity with the reference (crypto/threshold/dsa/dsa_core.go):

- phase 1 (req empty): every server deals joint Shamir shares of random
  k, a (threshold t) and zero-shares b, c (threshold 2t), each
  per-recipient **encrypted through the message-security layer** with a
  fresh nonce (dsa_core.go:97-119, 177-200);
- phase 2: a server aggregates the shares addressed to it, answers
  ``r_i = g^{a_i}``, ``v_i = k_i·a_i + b_i``; the client combines
  ``r = (Π r_i^{λ_i})^{(Σ v_i λ_i)^{-1}}`` (dsa_core.go:128-143,
  dsa.go:33-52);
- phase 3: ``s_i = k_i(m + x_i·r) + c_i``, client Lagrange-combines s
  (dsa_core.go:144-160, 389-403);
- each phase needs 2t responses (dsa_core.go:318-373); the client raises
  ``ERR_CONTINUE`` to advance the phase loop.

The group abstraction (``GroupOperations``/``Group``,
dsa_core.go:25-36) hides mod-p vs elliptic arithmetic; the mod-p
instantiation batches its Lagrange exponentiations through the batched
modexp engine (kernel K2), the EC one through the batched scalar-mult path (kernel
K5).
"""

from __future__ import annotations

import io
import os
import struct
from dataclasses import dataclass
from typing import Protocol

from bftkv_tpu_torch.crypto import sss
from bftkv_tpu_torch.errors import (
    ERR_CONTINUE,
    ERR_INVALID_RESPONSE,
    ERR_KEY_NOT_FOUND,
    ERR_MALFORMED_REQUEST,
    ERR_SHARE_NOT_FOUND,
    Error,
)
from bftkv_tpu_torch.packet import read_bigint, read_chunk, write_bigint, write_chunk

from bftkv_tpu_torch.crypto.threshold import ThresholdAlgo

__all__ = ["DsaContext", "Group", "GroupOperations", "PartialR"]


@dataclass
class PartialR:
    x: int
    ri: bytes
    vi: int


class GroupOperations(Protocol):
    """(reference: dsa_core.go:25-31)."""

    def calculate_partial_r(self, ai: int) -> bytes: ...

    def calculate_r(self, rs: list[PartialR]) -> int: ...

    def subgroup_order(self) -> int: ...

    def serialize(self, buf: io.BytesIO) -> None: ...

    def os2i(self, os: bytes) -> int: ...


class Group(Protocol):
    """(reference: dsa_core.go:33-36)."""

    def parse_key(self, key) -> tuple[GroupOperations, int]: ...

    def parse_params(self, r: io.BytesIO) -> GroupOperations: ...


# -- wire formats (reference: dsa_core.go:405-637) -------------------------


def _serialize_coord(buf: io.BytesIO, c: sss.Coordinate) -> None:
    buf.write(struct.pack(">Q", c.x))
    write_bigint(buf, c.y)


def _parse_coord(r: io.BytesIO) -> sss.Coordinate:
    (x,) = struct.unpack(">Q", r.read(8))
    return sss.Coordinate(x, read_bigint(r))


def _serialize_share(
    k: sss.Coordinate, a: sss.Coordinate, b: sss.Coordinate, c: sss.Coordinate
) -> bytes:
    buf = io.BytesIO()
    for coord in (k, a, b, c):
        _serialize_coord(buf, coord)
    return buf.getvalue()


def _parse_share(data: bytes) -> tuple[sss.Coordinate, ...]:
    r = io.BytesIO(data)
    return tuple(_parse_coord(r) for _ in range(4))


def _serialize_joint_share(shares: list[tuple[bytes, int]]) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack(">H", len(shares)))
    for coords, nid in shares:
        write_chunk(buf, coords)
        buf.write(struct.pack(">Q", nid))
    return buf.getvalue()


def _parse_joint_share(data: bytes) -> list[tuple[bytes, int]]:
    try:
        r = io.BytesIO(data)
        (cnt,) = struct.unpack(">H", r.read(2))
        out = []
        for _ in range(cnt):
            coords = read_chunk(r) or b""
            (nid,) = struct.unpack(">Q", r.read(8))
            out.append((coords, nid))
        return out
    except Error:
        raise
    except Exception:
        raise ERR_MALFORMED_REQUEST from None


def _serialize_sign_request(
    m: int | None, r: int | None, kmap: dict[int, list[bytes]] | None
) -> bytes:
    buf = io.BytesIO()
    if kmap is not None:
        buf.write(b"\x00")
        buf.write(struct.pack(">H", len(kmap)))
        for nid, shares in kmap.items():
            buf.write(struct.pack(">Q", nid))
            buf.write(struct.pack(">H", len(shares)))
            for share in shares:
                write_chunk(buf, share)
    else:
        buf.write(b"\x01")
        write_bigint(buf, m)
        write_bigint(buf, r)
    return buf.getvalue()


def _parse_sign_request(
    data: bytes, self_id: int
) -> tuple[int | None, int | None, list[bytes] | None]:
    """Returns (m, r, self's share list) (reference: dsa_core.go:478-491).

    Phase-0 payloads carry every recipient's encrypted shares; only the
    entry addressed to ``self_id`` is extracted."""
    try:
        r = io.BytesIO(data)
        phase = r.read(1)
        if not phase:
            raise ERR_MALFORMED_REQUEST
        if phase[0] == 0:
            (cnt,) = struct.unpack(">H", r.read(2))
            for _ in range(cnt):
                (nid,) = struct.unpack(">Q", r.read(8))
                (nshares,) = struct.unpack(">H", r.read(2))
                shares = [read_chunk(r) or b"" for _ in range(nshares)]
                if nid == self_id:
                    return None, None, shares
            raise ERR_SHARE_NOT_FOUND
        m = read_bigint(r)
        rr = read_bigint(r)
        return m, rr, None
    except Error:
        raise
    except Exception:
        raise ERR_MALFORMED_REQUEST from None


def _serialize_partial_signature(
    group: GroupOperations, x: int, s: bytes, v: int | None
) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack(">Q", x))
    write_chunk(buf, s)
    write_bigint(buf, v)
    group.serialize(buf)
    return buf.getvalue()


def _parse_partial_signature(
    g: Group, data: bytes
) -> tuple[GroupOperations, int, bytes, int]:
    r = io.BytesIO(data)
    (x,) = struct.unpack(">Q", r.read(8))
    s = read_chunk(r) or b""
    v = read_bigint(r)
    group = g.parse_params(r)
    return group, x, s, v


def _serialize_partial_param(
    group: GroupOperations, share: sss.Coordinate, t: int, nodes: list
) -> bytes:
    buf = io.BytesIO()
    group.serialize(buf)
    _serialize_coord(buf, share)
    buf.write(struct.pack(">H", t))
    for node in nodes:
        buf.write(node.serialize())
    return buf.getvalue()


def _parse_partial_param(
    g: Group, data: bytes
) -> tuple[GroupOperations, sss.Coordinate, int, list]:
    from bftkv_tpu_torch.crypto import cert as certmod

    try:
        r = io.BytesIO(data)
        group = g.parse_params(r)
        share = _parse_coord(r)
        (t,) = struct.unpack(">H", r.read(2))
        nodes = certmod.parse(r.read())
        return group, share, t, nodes
    except Error:
        raise
    except Exception:
        raise ERR_MALFORMED_REQUEST from None


# -- server context (reference: dsa_core.go:42-260) ------------------------


def _generate_joint_random(t: int, n: int, m: int) -> list[sss.Coordinate]:
    import secrets as pysecrets

    return sss.distribute(pysecrets.randbelow(m), n, t, m)


def _generate_joint_zero(t: int, n: int, m: int) -> list[sss.Coordinate]:
    return sss.distribute(0, n, t, m)


class DsaContext:
    """One per (crypto bundle, group plugin) — both the server's Sign
    handler and the client's process factory."""

    def __init__(self, crypt, g: Group, algo: ThresholdAlgo):
        self.g = g
        self.crypt = crypt
        self.algo = algo
        self.nodes: list = []
        self.n = 0
        self.t = 0
        self._kmap: dict[int, tuple[int, int]] = {}  # peer -> (ki, ci)
        self._nonces: dict[int, bytes] = {}

    # -- dealer ----------------------------------------------------------
    def distribute(self, key, nodes: list, t: int):
        if t * 2 > len(nodes):
            t = len(nodes) // 2  # clamp (reference: dsa_core.go:68-71)
        self.nodes = list(nodes)
        self.n = len(nodes)
        self.t = t
        group, x = self.g.parse_key(key)
        q = group.subgroup_order()
        coords = sss.distribute(x, self.n, t, q)
        shares = [
            _serialize_partial_param(group, c, t, self.nodes) for c in coords
        ]
        return shares, self.algo

    # -- server ----------------------------------------------------------
    def sign(
        self, sec: bytes, req: bytes | None, peer_id: int, self_id: int
    ) -> bytes | None:
        """Requests come off the wire from untrusted clients: malformed
        bytes fail closed as interned errors, never raw parse
        exceptions."""
        try:
            return self._sign(sec, req, peer_id, self_id)
        except Error:
            raise
        except Exception:
            raise ERR_MALFORMED_REQUEST from None

    def _sign(
        self, sec: bytes, req: bytes | None, peer_id: int, self_id: int
    ) -> bytes | None:
        group, share, t, nodes = _parse_partial_param(self.g, sec)
        q = group.subgroup_order()
        if not req:
            # first phase: deal joint shares of k, a (t) and b, c (2t)
            n = len(nodes)
            k = _generate_joint_random(t, n, q)
            a = _generate_joint_random(t, n, q)
            b = _generate_joint_zero(t * 2, n, q)
            c = _generate_joint_zero(t * 2, n, q)
            return _serialize_joint_share(
                self._encrypt_shares(k, a, b, c, nodes, peer_id)
            )
        m, r, k_share = _parse_sign_request(req, self_id)
        if k_share is not None:
            # second phase: aggregate own shares, emit (r_i, v_i)
            x, ki, ai, bi, ci = self._decrypt_shares(k_share, q, self_id, peer_id)
            ri = group.calculate_partial_r(ai)
            vi = (ki * ai + bi) % q
            self._kmap[peer_id] = (ki, ci)
            return _serialize_partial_signature(group, x, ri, vi)
        # final phase: s_i = k_i(m + x_i·r) + c_i
        if m is None or r is None:
            raise ERR_MALFORMED_REQUEST
        kc = self._kmap.get(peer_id)
        if kc is None:
            raise ERR_KEY_NOT_FOUND
        ki, ci = kc
        si = (ki * ((m + r * share.y) % q) + ci) % q
        return _serialize_partial_signature(
            group, share.x, si.to_bytes((si.bit_length() + 7) // 8 or 1, "big"), None
        )

    def _encrypt_shares(
        self, k, a, b, c, nodes: list, peer_id: int
    ) -> list[tuple[bytes, int]]:
        """Per-recipient encryption through the message layer with a
        fresh nonce (reference: dsa_core.go:177-200)."""
        nonce = os.urandom(16)
        out = []
        for i, peer in enumerate(nodes):
            data = _serialize_share(k[i], a[i], b[i], c[i])
            # Shares are store-and-forward (relayed through the client),
            # so there is no transport retry channel for a session the
            # recipient never learned — always use the self-contained
            # bootstrap envelope here.
            cipher = self.crypt.message.encrypt(
                [peer], data, nonce, force_bootstrap=True
            )
            out.append((cipher, peer.id))
        self._nonces[peer_id] = nonce
        return out

    def _decrypt_shares(
        self, shares: list[bytes], q: int, self_id: int, peer_id: int
    ) -> tuple[int, int, int, int, int]:
        """Sum the received share coordinates; the share this server
        dealt to itself must carry the nonce it generated (freshness —
        reference: dsa_core.go:202-245)."""
        x = -1
        ki = ai = bi = ci = 0
        saw_self = False
        for share in shares:
            plain, sender, nonce = self.crypt.message.decrypt(share)
            if sender.id == self_id:
                if self._nonces.get(peer_id) != nonce:
                    raise ERR_SHARE_NOT_FOUND
                saw_self = True
            try:
                k, a, b, c = _parse_share(plain)
            except Exception:
                raise ERR_MALFORMED_REQUEST from None
            if x < 0:
                x = k.x
            if not (k.x == x and a.x == x and b.x == x and c.x == x):
                raise ERR_MALFORMED_REQUEST
            ki = (ki + k.y) % q
            ai = (ai + a.y) % q
            bi = (bi + b.y) % q
            ci = (ci + c.y) % q
        if not saw_self:
            raise ERR_SHARE_NOT_FOUND
        return x, ki, ai, bi, ci

    # -- client ----------------------------------------------------------
    def new_process(
        self, tbs: bytes, algo: ThresholdAlgo, hash_name: str
    ) -> "DsaProcess":
        import hashlib

        dgst = hashlib.new(hash_name, tbs).digest()
        return DsaProcess(self.nodes, self.t, self.n, dgst, self.g)


class DsaProcess:
    """Three-phase client accumulator (reference: dsa_core.go:263-373)."""

    def __init__(self, nodes: list, t: int, n: int, dgst: bytes, g: Group):
        self.nodes = list(nodes)
        self.t = t
        self.n = n
        self.dgst = dgst
        self.g = g
        self.m: int | None = None
        self.r: int | None = None
        self.kmap: dict[int, list[bytes]] = {}
        self.ri: list[PartialR] = []
        self.si: list[sss.Coordinate] = []
        self.phase = 0
        self.result: bytes | None = None

    def make_request(self) -> tuple[list | None, bytes | None]:
        if self.phase == 0:
            req = None  # the empty request triggers the dealing phase
        elif self.phase == 1:
            req = _serialize_sign_request(None, None, self.kmap)
        elif self.phase == 2:
            req = _serialize_sign_request(self.m, self.r, None)
        else:
            return None, None
        nodes = self.nodes
        self.nodes = []  # refilled by responders; next round targets them
        return nodes, req

    def process_response(self, data: bytes, peer) -> bytes | None:
        try:
            return self._process(data, peer)
        except Error:
            raise
        except Exception:
            raise ERR_INVALID_RESPONSE from None

    def _process(self, data: bytes, peer) -> bytes | None:
        self.nodes.append(peer)
        if self.phase == 0:
            for coords, nid in _parse_joint_share(data):
                self.kmap.setdefault(nid, []).append(coords)
            th = max((len(v) for v in self.kmap.values()), default=0)
            if th >= 2 * self.t:
                self.phase += 1
                raise ERR_CONTINUE
            return None
        if self.phase == 1:
            group, x, ri, vi = _parse_partial_signature(self.g, data)
            self.ri.append(PartialR(x, ri, vi))
            if len(self.ri) >= 2 * self.t:
                self.r = group.calculate_r(self.ri)
                self.m = group.os2i(self.dgst)
                self.phase += 1
                raise ERR_CONTINUE
            return None
        if self.phase == 2:
            group, x, si, _ = _parse_partial_signature(self.g, data)
            self.si.append(sss.Coordinate(x, int.from_bytes(si, "big")))
            if len(self.si) >= 2 * self.t:
                q = group.subgroup_order()
                s = self._calculate_s(q)
                self.result = _format_dsa(self.r, s, q)
                self.phase += 1
                return self.result
            return None
        if self.result is not None:
            return self.result
        raise ERR_INVALID_RESPONSE

    def _calculate_s(self, q: int) -> int:
        """s = Σ s_i·λ_i mod q (reference: dsa_core.go:389-403)."""
        xs = [c.x for c in self.si]
        s = 0
        for c in self.si:
            s = (s + c.y * sss.lagrange(c.x, xs, q)) % q
        return s


def _format_dsa(r: int, s: int, q: int) -> bytes:
    """Raw (not DER) r ‖ s, each padded to the order size
    (reference: dsa_core.go:375-387)."""
    size = (q.bit_length() + 7) // 8
    return r.to_bytes(size, "big") + s.to_bytes(size, "big")
